"""The configurations and the JAX side of the port's ZeRO tests
(``tests/test_torch_zero.py``, ``tests/test_torch_zero_ranks.py``): the
reference's cases as plain data (weights, batches, strategy settings,
mesh degrees), which the port's rank processes take, and the JAX step that
runs each on its host mesh."""
import numpy as np

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import DistributedTrainStep as JStep


def _weights(sizes, seed, act):
    paddle.seed(seed)
    layers = []
    for i in range(len(sizes) - 1):
        layers.append(jnn.Linear(sizes[i], sizes[i + 1]))
        if i < len(sizes) - 2:
            layers.append({"gelu": jnn.GELU, "relu": jnn.ReLU}[act]())
    m = jnn.Sequential(*layers)
    return {k: np.asarray(v._value).copy() for k, v in m.state_dict().items()}


def _case(stage=0, mesh=None, mdt="float32", kind="adam", steps=6,
          amp=False, opt=None, opt_kw=None, lr=None, clip=None):
    """The reference's cases: ``adam`` is test_dist_train_step's (16 ->
    64 GELU -> 8, Adam 1e-2, MSE, 6 batches of 16); ``adamw`` is
    test_offload_moments' (32 -> 64 ReLU -> 8, AdamW 1e-2, cross
    entropy, one batch of 16 eight times).  ``opt`` / ``opt_kw`` / ``lr``
    replace the optimizer, ``clip`` (``(class name, clip_norm)``) adds a
    clip."""
    case = _base_case(stage, mesh, mdt, kind, steps, amp)
    if opt is not None:
        case["opt"] = opt
    if opt_kw is not None:
        case["opt_kw"] = opt_kw
    if lr is not None:
        case["lr"] = lr
    if clip is not None:
        case["clip_kind"], case["clip"] = clip
    return case


def _base_case(stage, mesh, mdt, kind, steps, amp):
    st = {}
    if stage:
        st["sharding"] = True
        st["sharding_configs"] = {"stage": stage, "moment_dtype": mdt}
    if amp:
        st["amp"] = True
        st["amp_configs"] = {"dtype": "bfloat16"}
    if kind == "adam":
        rng = np.random.default_rng(5)
        xs = rng.normal(size=(steps, 16, 16)).astype(np.float32)
        ys = rng.normal(size=(steps, 16, 8)).astype(np.float32)
        return dict(weights=_weights([16, 64, 8], 11, "gelu"),
                    sizes=[16, 64, 8], act="gelu", loss="mse", opt="Adam",
                    lr=1e-2, strategy=st, mesh=mesh, xs=xs, ys=ys)
    rng = np.random.RandomState(0)
    x = rng.rand(16, 32).astype("float32")
    y = rng.randint(0, 8, (16,)).astype(np.int64)
    return dict(weights=_weights([32, 64, 8], 0, "relu"), sizes=[32, 64, 8],
                act="relu", loss="ce", opt="AdamW", lr=1e-2, strategy=st,
                mesh=mesh, xs=np.stack([x] * steps),
                ys=np.stack([y] * steps))


def _jax_run(case, ndev):
    """The reference's step on ``ndev`` host devices (its mesh from the
    case's degrees)."""
    jmesh.set_mesh(None)
    mesh = jmesh.init_mesh(case["mesh"] or {"dp": 1},
                           devices=jax.devices()[:ndev])
    layers = []
    for i in range(len(case["sizes"]) - 1):
        layers.append(jnn.Linear(case["sizes"][i], case["sizes"][i + 1]))
        if i < len(case["sizes"]) - 2:
            layers.append({"gelu": jnn.GELU,
                           "relu": jnn.ReLU}[case["act"]]())
    m = jnn.Sequential(*layers)
    m.set_state_dict({k: paddle.to_tensor(v)
                      for k, v in case["weights"].items()})
    kw = dict(case.get("opt_kw", {}))
    if "clip" in case:
        kw["grad_clip"] = getattr(paddle.nn, case["clip_kind"])(case["clip"])
    opt = getattr(paddle.optimizer, case["opt"])(
        learning_rate=case["lr"], parameters=m.parameters(), **kw)
    s = JStrategy()
    for k, v in case["strategy"].items():
        setattr(s, k, v)

    def loss_fn(x, y):
        if case["loss"] == "mse":
            return ((m(x) - y) ** 2).mean()
        return JF.cross_entropy(m(x), y)

    step = JStep(m, loss_fn, opt, s, mesh=mesh)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y))._value)
              for x, y in zip(case["xs"], case["ys"])]
    params = {k: np.asarray(v._value) for k, v in m.state_dict().items()}
    jmesh.set_mesh(None)
    return dict(losses=losses, params=params, opt=opt, model=m)


W2_CASES = [_case(0, {"dp": 2}), _case(1, {"fsdp": 2}), _case(2, {"fsdp": 2}),
            _case(3, {"fsdp": 2}),
            _case(2, {"fsdp": 2}, amp=True),
            _case(3, {"fsdp": 2}, "bfloat16", kind="adamw", steps=8),
            # norms over split parameters: the clips' and Lamb's / Lars's
            # sums of squares span both ranks' rows (both clips engage)
            _case(1, {"fsdp": 2}, clip=("ClipGradByGlobalNorm", 0.05)),
            _case(3, {"fsdp": 2}, clip=("ClipGradByNorm", 0.05)),
            _case(2, {"fsdp": 2}, opt="Lamb"),
            _case(3, {"fsdp": 2}, opt="Lars", lr=1.0,
                  opt_kw={"lars_coeff": 0.05})]
SPLIT_NORM_CASES = range(6, 10)
W4_CASES = [_case(3, {"dp": 2, "fsdp": 2}),
            _case(3, {"dp": 2, "fsdp": 2}, "int8", kind="adamw", steps=8),
            _case(3, {"dp": 2, "fsdp": 2}, "float32", kind="adamw", steps=8)]


def _jax_state(opt, model):
    """The JAX optimizer's state by parameter name, bf16 as f32."""
    names = [n for n, _ in model.named_parameters()]
    return {n: {k: np.asarray(v.astype(jnp.float32)
                              if v.dtype == jnp.bfloat16 else v)
                for k, v in st.items()}
            for n, st in zip(names, opt.opt_state())}


def _load_case():
    """The JAX int8 step (ZeRO-3, two devices) after three steps: its
    weights and state go to the port's two ranks, which take their rows
    and run a fourth step."""
    case = _case(3, {"fsdp": 2}, "int8", kind="adamw", steps=3)
    ref = _jax_run(case, 2)
    nxt = _case(3, {"fsdp": 2}, "int8", kind="adamw", steps=1)
    nxt["weights"] = ref["params"]
    nxt["load_state"] = _jax_state(ref["opt"], ref["model"])
    return nxt, ref


def _close(a, b, tol, what):
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol,
                                   err_msg=f"{what} {k}")


def _ranks_equal(res):
    for r in res[1:]:
        for k, v in res[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
        assert r["losses"] == res[0]["losses"]


# -- the spec rules ------------------------------------------------------
