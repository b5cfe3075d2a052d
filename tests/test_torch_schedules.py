"""The port's schedules (``repro_torch.optim.schedules``) against
``repro.optim.schedules`` over a grid of steps, given as Python ints and
as scalar tensors / arrays: float32 results, bit-equal — except the
cosine, whose ``cos`` is glibc's ``cosf`` in XLA and PyTorch's own
vectorised one here (they part by one ulp at a few percent of inputs).  A
cos one ulp (≤ 2⁻²⁴ on [−1, 1]) off moves ``floor + ½(base − floor)(1 +
cos)`` by ½(base − floor)·2⁻²⁴, many ulps of the result where 1 + cos
nearly cancels, so the cosine is held to twice that plus one ulp of the
result.  No schedule on a twin's path takes a cosine: fig2's λ comes from
``lambda_increase``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

STEPS = list(range(0, 220)) + [299, 300, 301, 999, 1000, 1001, 5000]
EXACT = [("constant", (0.1,)), ("constant", (3e-4,)),
         ("step_decay", (0.1, (10, 50), (0.5, 0.1))),
         ("step_decay", (0.3, (100,), (0.7,))),
         ("lambda_increase", ()),
         ("lambda_increase", ((3, 7), (0.1, 0.5, 1.0))),
         ("lambda_increase", ((10,), (0.05, 2.0)))]
COSINE = [(0.3, 1000, 100, 0.01), (1e-3, 777, 0, 0.0), (0.1, 50, 10, 0.0)]


def _values(name, args):
    got, want = [], []
    port, ref = getattr(schedules, name)(*args), getattr(jsched, name)(*args)
    for s in STEPS:
        for step_t, step_j in ((s, s), (torch.tensor(s), jnp.asarray(s))):
            g = port(step_t)
            assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
            assert g.dim() == 0
            got.append(g.numpy())
            want.append(np.asarray(ref(step_j)))
    got, want = np.stack(got), np.stack(want)
    assert want.dtype == np.float32
    return got, want


@pytest.mark.parametrize("name,args", EXACT,
                         ids=[f"{n}{a}" for n, a in EXACT])
def test_schedule_bit_equal_to_reference(name, args):
    got, want = _values(name, args)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("args", COSINE, ids=str)
def test_cosine_within_one_ulp_of_reference(args):
    base, _, _, floor = args
    got, want = _values("cosine", args)
    tol = (base - floor) * 2.0 ** -24 + np.spacing(np.abs(want))
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol)


def test_lambda_increase_hands_the_round_the_reference_lambda():
    """``float(lam_schedule(t))`` is what the simulation passes the round:
    0.1 reaches it as float32(0.1), as in the reference."""
    fn, ref = schedules.lambda_increase((2, 4)), jsched.lambda_increase((2, 4))
    lams = [float(fn(t)) for t in range(6)]
    assert lams == [float(ref(t)) for t in range(6)]
    assert lams[0] == float(np.float32(0.1)) != 0.1


def test_lambda_increase_refuses_mismatched_values():
    with pytest.raises(ValueError, match="2 boundaries need 3 values"):
        schedules.lambda_increase((1, 2), (0.1, 0.5))
