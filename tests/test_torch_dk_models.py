"""The port's dist-keras models (``distkeras_torch.models.mlp`` / ``cnn``)
and the helpers around them against the JAX package on the CPU.

- Logits of ``mlp`` (features (32, 16)), ``mnist_cnn`` and ``cifar_cnn``
  (widths (8, 16, 32)) against the reference's ``apply`` on the same
  weights (seeded numpy draws, loaded through ``bridge.params_from_jax``;
  biases nonzero), batch 4: f32
  within 1e-5 of the largest logit, bf16 within 2e-2 of it. A
  ``Dense_0`` whose rows are laid out for a ``(c, h, w)`` flatten misses
  by far more, so the comparison pins flax's ``(h, w, c)`` order.
- The weight bridge round-trips every model exactly, bf16 ones included
  (f32 masters).
- The init: lecun-normal kernels with std ``sqrt(1 / fan_in)`` (flax
  divides its truncated normal by that distribution's std, 0.8796, so
  the drawn std is the target itself; the reference's measured within
  5% too), zero biases; threefry is not Philox, so moments are compared,
  not bits.
- ``model_spec``, ``Model.replace_params`` and ``Model.predict`` for the
  new models; ``uniform_weights``; the host-side narrowing cast
  (bit-equal to JAX's bf16 cast); the profiler trace and ``StepTimer``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distkeras_tpu.models import get_model as jax_get_model  # noqa: E402
from distkeras_torch import bridge  # noqa: E402
from distkeras_torch.models import get_model, model_spec  # noqa: E402
from distkeras_torch.models.wrapper import Model  # noqa: E402
from torch_spawn_util import one_thread  # noqa: E402,F401

CASES = {
    "mlp": (dict(features=(32, 16)), dict(in_features=784), (4, 28, 28, 1)),
    "mnist_cnn": ({}, {}, (4, 28, 28, 1)),
    "cifar_cnn": (dict(widths=(8, 16, 32)), {}, (4, 32, 32, 3)),
}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # of the largest |logit|


def _numpy_params(pm, rng):
    """A flax-layout tree of the port module's shapes drawn from ``rng``:
    kernels at std sqrt(1 / fan_in), biases at 0.1."""
    def draw(leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) or 10
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree.map(draw, bridge.params_to_jax(pm))


def _pair(name, dtype, seed=0):
    """The reference module, seeded numpy weights, the port module loaded
    with them, and a seeded input batch."""
    kw, port_kw, shape = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    jm = jax_get_model(name, dtype=getattr(jnp, dtype), **kw)
    pm = get_model(name, dtype=getattr(torch, dtype), device="cpu", **kw,
                   **port_kw)
    p = _numpy_params(pm, rng)
    bridge.params_from_jax(p, pm)
    return jm, p, pm, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_match_jax(name, dtype):
    jm, p, pm, x = _pair(name, dtype)
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), err


@pytest.mark.parametrize("name", ["mnist_cnn", "cifar_cnn"])
def test_flatten_order_is_flax_hwc(name):
    """Dense_0's rows re-laid for a (c, h, w) flatten give another
    function: the parity test above would catch that order."""
    jm, p, pm, x = _pair(name, "float32")
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    k = p["params"]["Dense_0"]["kernel"]
    H = W = {"mnist_cnn": 14, "cifar_cnn": 4}[name]
    C = k.shape[0] // (H * W)
    chw = k.reshape(H, W, C, -1).transpose(2, 0, 1, 3).reshape(k.shape)
    with torch.no_grad():
        pm.Dense_0.kernel.copy_(torch.from_numpy(chw))
        got = pm(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() > 100 * TOL["float32"] * np.abs(
        want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bridge_round_trip_is_exact(name, dtype):
    _, p, pm, _ = _pair(name, dtype, seed=1)
    back = bridge.params_to_jax(pm)
    flat_p, flat_b = jax.tree.leaves_with_path(p), jax.tree.leaves_with_path(
        back)
    assert [k for k, _ in flat_p] == [k for k, _ in flat_b]
    for (_, a), (_, b) in zip(flat_p, flat_b):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert all(q.dtype == torch.float32 for q in pm.parameters())


def test_lecun_normal_init_moments():
    """CIFAR CNN at full width: Conv_5 [3, 3, 256, 256] (fan_in 2304) and
    Dense_0 [4096, 256] have std within 5% of sqrt(1 / fan_in), as the
    reference's draw does; biases are zeros."""
    pm = get_model("cifar_cnn", device="cpu", seed=3)
    jp = jax.jit(jax_get_model("cifar_cnn").init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))["params"]
    for layer, fan_in in (("Conv_5", 9 * 256), ("Dense_0", 4096)):
        target = np.sqrt(1.0 / fan_in)
        kernel = getattr(pm, layer).kernel.detach().numpy()
        for std in (kernel.std(), np.asarray(jp[layer]["kernel"]).std()):
            assert abs(std / target - 1) < 0.05, (layer, std, target)
        assert abs(kernel.mean()) < 0.05 * target
        assert np.abs(kernel).max() <= 2 * target / 0.87962566103423978
    for name, q in pm.named_parameters():
        if name.endswith("bias"):
            assert not q.any()


def test_model_spec_replace_params_and_predict():
    jm, p, pm, x = _pair("cifar_cnn", "bfloat16", seed=2)
    spec = model_spec(pm)
    assert spec == {"name": "cifar_cnn", "kwargs": dict(
        num_classes=10, widths=(8, 16, 32), dtype=torch.bfloat16,
        input_shape=(32, 32, 3))}
    m = Model(pm)
    logits = m.predict(x)
    twin = m.replace_params(p)
    assert twin.module is not pm
    np.testing.assert_array_equal(twin.predict(x), logits)
    other = get_model(spec["name"], device="cpu", seed=9, **spec["kwargs"])
    assert not torch.equal(other.Conv_0.kernel, pm.Conv_0.kernel)
    with pytest.raises(ValueError, match="Unknown model"):
        get_model("resnet")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model("mnist_cnn")


def test_uniform_weights_is_pure_and_seeded():
    from distkeras_torch.utils.initializers import uniform_weights

    pm = get_model("mlp", features=(8,), in_features=6, device="cpu")
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    a = uniform_weights(pm.state_dict(), bounds=(-0.25, 0.25), seed=1)
    b = uniform_weights(pm.state_dict(), bounds=(-0.25, 0.25), seed=1)
    c = uniform_weights(pm.state_dict(), bounds=(-0.25, 0.25), seed=2)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, before[k])  # the input is left as it was
        assert a[k].shape == v.shape and a[k].dtype == v.dtype
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
        assert a[k].min() >= -0.25 and a[k].max() < 0.25
    fresh = uniform_weights(pm, bounds=(-0.25, 0.25), seed=1)
    assert fresh is not pm
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, a[k]) and torch.equal(pm.state_dict()[k],
                                                    before[k])
    with pytest.raises(ValueError, match="low < high"):
        uniform_weights(pm, bounds=(1.0, 1.0))


def test_narrow_cast_is_jax_bf16_cast():
    from distkeras_torch.utils.transfer import (narrow_cast,
                                                resolve_transfer_dtype)

    x = np.random.default_rng(0).normal(size=(64, 33)).astype(np.float32)
    x[0, :4] = [1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, np.inf, -0.0]  # ties
    got = narrow_cast(x, torch.bfloat16)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), want)
    assert narrow_cast(x, "bfloat16").dtype == torch.bfloat16
    ints = np.arange(5)
    assert narrow_cast(ints, torch.bfloat16) is ints
    assert narrow_cast(x, torch.float64) is x  # never widened
    assert narrow_cast(x, None) is x
    assert narrow_cast(x, np.float16).dtype == np.float16
    pm = get_model("mnist_cnn", device="cpu")
    assert resolve_transfer_dtype(pm, "auto") == torch.bfloat16
    assert resolve_transfer_dtype(pm, None) is None


def test_trace_and_step_timer(tmp_path):
    from distkeras_torch.utils.profiling import StepTimer, trace

    with trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    assert len(list((tmp_path / "t").glob("trace-*.json"))) == 1
    timer = StepTimer()
    with pytest.warns(RuntimeWarning, match="before start"):
        assert timer.stop() == 0.0
    timer.start()
    assert timer.stop(sync_on={"x": torch.ones(2)}) >= 0.0
    assert len(timer.durations) == 1 and timer.mean >= 0.0
