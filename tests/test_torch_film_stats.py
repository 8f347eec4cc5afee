"""bre_tpu_torch.film and bre_tpu_torch.utils.stats against bre_tpu's on the
CPU: the five reconstruction filters, the splat, the direct-assign path,
the splat's determinism, the stats report and the profiler trace."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bre_tpu import film as JF
from bre_tpu.utils import stats as JS
from bre_tpu_torch import film as TF
from bre_tpu_torch.utils import stats as TS

FILTERS = ("box", "triangle", "gaussian", "mitchell", "sinc")


@pytest.mark.parametrize("name", FILTERS)
def test_filter_eval_bits(name):
    """filter_eval stays numpy, as the reference's: the same bits at widths
    0.5 and 2 and at the default parameters."""
    x = np.random.RandomState(5).uniform(-3, 3, 2048)
    x[:3] = (0.0, 0.5, -2.0)
    for radius in (0.5, 2.0):
        with np.errstate(invalid="ignore"):  # sinc's unused 0/0 branch
            np.testing.assert_array_equal(TF.filter_eval(name, x, radius),
                                          JF.filter_eval(name, x, radius))
    with pytest.raises(ValueError):
        TF.filter_eval("lanczos", x)


def _samples(W, H, n, seed):
    rs = np.random.RandomState(seed)
    p = rs.uniform(-1.0, W + 1.0, (n, 2)).astype(np.float32)
    p[:64] = np.floor(p[:64]) + 0.5  # exactly on pixel centers
    p[64:128, 1] = rs.uniform(-1.0, H + 1.0, 64)  # past the edges too
    L = rs.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    return p, L


@pytest.mark.parametrize("width", [0.5, 2.0])
@pytest.mark.parametrize("name", FILTERS)
def test_add_samples_against_reference(name, width):
    """4,096 samples splatted into a 32x32 film: the image and the weight
    within rtol 1e-6 of their largest value (the splat's sum order is not
    XLA's)."""
    W = H = 32
    p, L = _samples(W, H, 4096, 6)
    ref = JF.add_samples(JF.make_film(W, H), jnp.asarray(p), jnp.asarray(L),
                         JF.FilterSpec(name, width, width))
    port = TF.add_samples(TF.make_film(W, H, device="cpu"),
                          torch.from_numpy(p), torch.from_numpy(L),
                          TF.FilterSpec(name, width, width))
    for a, b in ((ref.image, port.image), (ref.weight, port.weight),
                 (ref.weighted, port.weighted)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-6 * np.abs(a).max())
    assert port.image.dtype == torch.float32


def test_set_image_equal():
    img = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    ref = JF.set_image(JF.make_film(4, 2), jnp.asarray(img))
    port = TF.set_image(TF.make_film(4, 2, device="cpu"),
                        torch.from_numpy(img))
    np.testing.assert_array_equal(port.image.numpy(), np.asarray(ref.image))
    np.testing.assert_array_equal(port.weight.numpy(), np.asarray(ref.weight))


def test_add_samples_duplicate_ids_same_bits():
    """Many samples on a few pixels (every footprint offset sums hundreds of
    entries per pixel): two runs give the same bits."""
    rs = np.random.RandomState(7)
    n = 8192
    p = (rs.randint(0, 4, (n, 2)) + rs.uniform(0.3, 0.7, (n, 2))).astype(
        np.float32)
    L = rs.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    spec = TF.FilterSpec("gaussian", 2.0, 2.0)
    runs = [TF.add_samples(TF.make_film(8, 8, device="cpu"),
                           torch.from_numpy(p), torch.from_numpy(L), spec)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float(runs[0].weight[1, 1]) > 100.0


def test_stats_report_equals_reference():
    """The same counters give the same report, character for character,
    and the same dict; non-scalars are skipped as the reference skips
    them."""
    batches = [
        {"Photons/paths": 100, "Photons/medium interactions": 40,
         "Integrator/iterations": 1, "radius": 0.125},
        {"Photons/paths": 50, "nested": {"deep": 1, "deeper": {"x": 2.5}},
         "Integrator/iterations": 1, "skip": "text", "radius": 0.0625},
        {"Beams/count": 1234567, "Photons/paths": 7},
    ]
    ref, port = JS.StatsAccumulator(), TS.StatsAccumulator()
    for b in batches:
        ref.add({k: (jnp.asarray(v) if isinstance(v, (int, float)) else v)
                 for k, v in b.items()})
        port.add({k: (torch.tensor(v) if isinstance(v, (int, float)) else v)
                  for k, v in b.items()})
    port.add({"vector": torch.ones(3)})
    ref.add({"vector": jnp.ones(3)})
    assert port.report() == ref.report()
    assert port.as_dict() == ref.as_dict()
    assert "1,234,567" in port.report()


def test_trace_to_cpu_writes_profile_phase(tmp_path):
    """trace_to on the CPU writes log_dir/trace.json, a Chrome trace that
    holds the profile_phase range."""
    log_dir = str(tmp_path / "trace")
    with TS.trace_to(log_dir, device="cpu"):
        with TS.profile_phase("film_splat"):
            x = torch.ones(64, 64)
            (x @ x).sum()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "film_splat" for e in events)
