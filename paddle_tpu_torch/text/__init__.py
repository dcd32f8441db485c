from . import generation  # noqa: F401
from . import models  # noqa: F401
from .generation import generate  # noqa: F401
