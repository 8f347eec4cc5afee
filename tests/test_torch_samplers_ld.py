"""The port's low-discrepancy samplers against bre_tpu's, on the CPU: the
radical inverses (static, dynamic, scrambled, inverse), the digit
permutations, Sobol' (samples and interval-to-index), the Halton stream,
the pixel samplers, and the per-dimension sampler streams of all six kinds
(``stream_camera_sample``, ``stream_1d``, ``stream_2d``) on seeded pixel and
sample indices.  bre_tpu runs eagerly (no jit).  Every value is compared
bit for bit: the port keeps the reference's integer arithmetic and its
float roundings (the two-limb conversion of the reversed digits, 1/base in
float32 or rounded from double where the reference does each).  The port's
copies of ``sobol_tables.npz`` and ``cmaxmindist.npy`` equal bre_tpu's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu.core import lowdiscrepancy as jld
from bre_tpu.core import rng as jrng
from bre_tpu.core import samplers as jsamp
from bre_tpu.core import sobol as jsobol
from bre_tpu_torch.core import lowdiscrepancy as tld
from bre_tpu_torch.core import rng as trng
from bre_tpu_torch.core import samplers as tsamp
from bre_tpu_torch.core import sobol as tsobol
from torch_parity import to_np

ROOT = Path(__file__).resolve().parents[1]
# uint32 indices: small ones (few digits), large ones, and the edges
IDX = np.concatenate([np.arange(40), np.random.RandomState(17).randint(
    0, 2 ** 32, 200, dtype=np.uint64), [2 ** 31, 2 ** 32 - 1, 123457]]
    ).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(t, j):
    np.testing.assert_array_equal(to_np(t), np.asarray(j))


def test_table_copies_equal_reference():
    for name in ("sobol_tables.npz", "cmaxmindist.npy"):
        ref = (ROOT / "bre_tpu" / "core" / "data" / name).read_bytes()
        own = (ROOT / "bre_tpu_torch" / "core" / "data" / name).read_bytes()
        assert own == ref, name
    m, vdc, vdc_inv = tsobol.sobol_tables()
    _eq(m, jsobol.SOBOL_MATRICES)
    _eq(vdc, jsobol.VDC_SOBOL_MATRICES)
    _eq(vdc_inv, jsobol.VDC_SOBOL_MATRICES_INV)
    np.testing.assert_array_equal(tld.PRIMES, jld.PRIMES)
    np.testing.assert_array_equal(tld.PRIME_SUMS, jld.PRIME_SUMS)


def test_missing_sobol_table_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tsobol, "_TABLES", None)
    monkeypatch.setattr(tsobol, "TABLES", tmp_path / "missing.npz")
    with pytest.raises(FileNotFoundError):
        tsobol.sobol_sample(_t([1, 2]), 3)


@pytest.mark.parametrize("bi", [0, 1, 2, 3, 10, 127, 500, 999])
def test_radical_inverse_bits(bi):
    a_t, a_j = _t(IDX), jnp.asarray(IDX)
    _eq(tld.radical_inverse(bi, a_t), jld.radical_inverse(bi, a_j))
    want = jld.radical_inverse_dynamic(jnp.full(IDX.shape, bi, jnp.int32), a_j)
    _eq(tld.radical_inverse_dynamic(bi, a_t), want)
    _eq(tld.radical_inverse_dynamic(torch.full(IDX.shape, bi), a_t), want)


def test_radical_inverse_per_lane_bases():
    RS = np.random.RandomState(1)
    bi = RS.randint(0, 1000, IDX.shape[0]).astype(np.int32)
    _eq(tld.radical_inverse_dynamic(_t(bi), _t(IDX)),
        jld.radical_inverse_dynamic(jnp.asarray(bi), jnp.asarray(IDX)))
    bs = RS.randint(0, tld.N_SCRAMBLE_DIMS, IDX.shape[0]).astype(np.int32)
    _eq(tld.scrambled_radical_inverse_dynamic(_t(bs), _t(IDX)),
        jld.scrambled_radical_inverse_dynamic(jnp.asarray(bs),
                                              jnp.asarray(IDX)))


@pytest.mark.parametrize("bi", [0, 1, 4, 33, 127])
def test_scrambled_radical_inverse_bits(bi):
    _eq(tld.scrambled_radical_inverse_dynamic(bi, _t(IDX)),
        jld.scrambled_radical_inverse_dynamic(bi, jnp.asarray(IDX)))


def test_permutations_and_inverse_radical_inverse():
    pt, ot = tld.radical_inverse_permutations()
    pj, oj = jld.radical_inverse_permutations()
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ot, oj)
    for base, nd in ((2, 7), (3, 5), (2, 0), (3, 21)):
        _eq(tld.inverse_radical_inverse(base, _t(IDX), nd),
            jld.inverse_radical_inverse(base, jnp.asarray(IDX), nd))


@pytest.mark.parametrize("dim", [0, 1, 5, 1023])
def test_sobol_sample_bits(dim):
    RS = np.random.RandomState(2)
    hi = RS.randint(0, 2 ** 20, IDX.shape[0]).astype(np.uint32)
    scr = RS.randint(0, 2 ** 32, IDX.shape[0], dtype=np.uint64).astype(np.uint32)
    _eq(tsobol.sobol_sample_u32(_t(IDX), dim, _t(scr)),
        jsobol.sobol_sample_u32(jnp.asarray(IDX), dim, jnp.asarray(scr)))
    _eq(tsobol.sobol_sample(_t(IDX), dim, a_hi=_t(hi)),
        jsobol.sobol_sample(jnp.asarray(IDX), dim, a_hi=jnp.asarray(hi)))
    dims = RS.randint(0, 1024, IDX.shape[0]).astype(np.int32)
    _eq(tsobol.sobol_sample(_t(IDX), _t(dims), a_hi=_t(hi)),
        jsobol.sobol_sample(jnp.asarray(IDX), jnp.asarray(dims),
                            a_hi=jnp.asarray(hi)))


@pytest.mark.parametrize("m", [0, 1, 3, 9, 16, 17, 25])
def test_sobol_interval_to_index_bits(m):
    RS = np.random.RandomState(3)
    n = 64
    frame = RS.randint(0, 2 ** 16, n).astype(np.uint32)
    px = RS.randint(0, 1 << m, n).astype(np.uint32)
    py = RS.randint(0, 1 << m, n).astype(np.uint32)
    th, tl = tsobol.sobol_interval_to_index(m, _t(frame), _t(px), _t(py))
    jh, jl = jsobol.sobol_interval_to_index(m, jnp.asarray(frame),
                                            jnp.asarray(px), jnp.asarray(py))
    _eq(th, jh)
    _eq(tl, jl)


def _draws_u32(s_t, s_j):
    np.testing.assert_array_equal(
        to_np(trng.pcg32_next_u32(s_t)[1]),
        np.asarray(jrng.pcg32_next_u32(s_j)[1]).astype(np.int64))


def test_halton_stream_bits():
    """AwesomeHaltonSampler: 41 draws in vsppm's order (1D, 2D pairs as
    (second, first)), the PCG32 fallback in lockstep, and past dimension
    999 the PCG32 values."""
    idx = (np.arange(300) * 7919 + 12345).astype(np.uint32)
    ht = tsamp.halton_stream_init(_t(idx))
    hj = jsamp.halton_stream_init(jnp.asarray(idx))
    for k in range(41):
        if k % 3:
            ht, vt = tsamp.halton_next_2d(ht)
            hj, vj = jsamp.halton_next_2d(hj)
        else:
            ht, vt = tsamp.halton_next_1d(ht)
            hj, vj = jsamp.halton_next_1d(hj)
        _eq(vt, vj)
    assert ht.dim == int(hj.dim[0])
    _draws_u32(ht.rng, hj.rng)
    ht = ht._replace(dim=998)
    hj = hj._replace(dim=jnp.full(idx.shape, 998, jnp.int32))
    for _ in range(3):  # dims 998, 999, then the fallback at 1000
        ht, vt = tsamp.halton_next_1d(ht)
        hj, vj = jsamp.halton_next_1d(hj)
        _eq(vt, vj)


def test_pixel_samplers_bits():
    RS = np.random.RandomState(4)
    n = IDX.shape[0]
    scr = RS.randint(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    a_t, a_j = _t(IDX), jnp.asarray(IDX)
    _eq(tsamp.vandercorput(a_t, _t(scr[:, 0])),
        jsamp.vandercorput(a_j, jnp.asarray(scr[:, 0])))
    _eq(tsamp.sobol2(a_t, _t(scr[:, 1])),
        jsamp.sobol2(a_j, jnp.asarray(scr[:, 1])))
    _eq(tsamp.zero_two_sequence_2d(a_t, _t(scr)),
        jsamp.zero_two_sequence_2d(a_j, jnp.asarray(scr)))
    small = (IDX % 64).astype(np.uint32)
    rot = RS.rand(n).astype(np.float32)
    for spp in (1, 16, 64):
        _eq(tsamp.maxmindist_2d(_t(small), spp, torch.from_numpy(rot),
                                _t(scr[:, 0])),
            jsamp.maxmindist_2d(jnp.asarray(small), spp, jnp.asarray(rot),
                                jnp.asarray(scr[:, 0])))
        u = RS.rand(n, 2).astype(np.float32)
        _eq(tsamp.stratified_2d(_t(small), spp, torch.from_numpy(u)),
            jsamp.stratified_2d(jnp.asarray(small), spp, jnp.asarray(u)))
    _eq(tsamp.halton_2d(a_t, _t(scr[:, 0])),
        jsamp.halton_2d(a_j, jnp.asarray(scr[:, 0])))


@pytest.mark.parametrize("kind", tsamp.KINDS)
def test_camera_jitter_bits(kind):
    pix = np.arange(50, dtype=np.uint32) * 3 + 1
    for s in (0, 5):
        rt, jt = tsamp.camera_jitter(kind, _t(pix), s, 16,
                                     trng.pcg32_init(_t(pix + 9)))
        rj, jj = jsamp.camera_jitter(kind, jnp.asarray(pix), s, 16,
                                     jrng.pcg32_init(jnp.asarray(pix + 9)))
        _eq(jt, jj)
        _draws_u32(rt, rj)


@pytest.mark.parametrize("kind", tsamp.KINDS)
def test_sample_streams_bits(kind):
    """make_sample_stream + stream_camera_sample, 12 draws mixing 1D and
    2D, then, from 3 dimensions below the end of the low-discrepancy
    dimensions (halton 128, sobol 1024), 6 more into the PCG32 fallback,
    on a 13x7 film at samples 0, 3 and 11 of 16: the port's stream holds
    the three samples' lanes at once, the reference's one sample each."""
    W, H, spp, R = 13, 7, 16, 91
    spec_t = tsamp.make_stream_spec(kind, W, H, spp)
    spec_j = jsamp.make_stream_spec(kind, W, H, spp)
    for f in ("spp", "base_scale2", "base_scale3", "base_exp2", "base_exp3",
              "mult_inv2", "mult_inv3", "log2res"):
        assert getattr(spec_t, f) == getattr(spec_j, f), f
    samples = (0, 3, 11)
    pix = np.arange(R, dtype=np.int64)
    lane_pix = np.tile(pix, len(samples))
    lane_s = np.repeat(samples, R)
    raw = trng.pcg32_init(_t((lane_s * R + lane_pix + 0x9E37) & 0xFFFFFFFF))
    st = tsamp.make_sample_stream(spec_t, _t(lane_pix), _t(lane_pix % W),
                                  _t(lane_pix // W), _t(lane_s), raw)
    jump = {"halton": 125, "sobol": 1021}.get(kind, 500)

    def draws(s, stream_1d, stream_2d, camera_sample, at_jump):
        s, film, time, lens = camera_sample(s)
        out = [film, time, lens]
        for k in range(18):
            if k == 12:
                s = at_jump(s)
            s, v = (stream_2d if k % 2 else stream_1d)(s)
            out.append(v)
        return s, out

    st, outs_t = draws(st, tsamp.stream_1d, tsamp.stream_2d,
                       tsamp.stream_camera_sample,
                       lambda s: s if kind == "random" else s._replace(dim=jump))
    for i, s in enumerate(samples):
        pj = jnp.asarray(pix.astype(np.uint32))
        rj = jrng.pcg32_init(jnp.uint32(s) * jnp.uint32(R) + pj
                             + jnp.uint32(0x9E37))
        sj = jsamp.make_sample_stream(spec_j, pj, pj % jnp.uint32(W),
                                      pj // jnp.uint32(W), jnp.uint32(s), rj)
        sj, outs_j = draws(
            sj, jsamp.stream_1d, jsamp.stream_2d, jsamp.stream_camera_sample,
            lambda s: s if kind == "random" else s._replace(dim=jnp.int32(jump)))
        lanes = slice(i * R, (i + 1) * R)
        for d, (vt, vj) in enumerate(zip(outs_t, outs_j)):
            np.testing.assert_array_equal(to_np(vt[lanes]), np.asarray(vj),
                                          err_msg=f"{kind} draw {d}")
        rt = tsamp.stream_rng(st)
        _draws_u32(trng.PCG32State(rt.state[lanes], rt.inc[lanes]),
                   jsamp.stream_rng(sj))


def test_unknown_sampler_raises():
    with pytest.raises(ValueError):
        tsamp.make_stream_spec("pmj02bn", 4, 4, 4)
