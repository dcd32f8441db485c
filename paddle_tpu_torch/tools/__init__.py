"""Scripts of the port that are run as modules (counterpart of the
reference's ``tools/``)."""
