"""The port's bucket EF-sign layer against the JAX package, on the CPU.

Inputs are made with numpy and fed to both sides. The JAX side runs as its
own tests run it: the Pallas kernels in interpret mode and ``ops.*`` through
its plain reference. The port side runs on CPU tensors, which is its plain
PyTorch path (``repro_torch.kernels.ref``); the CUDA kernels are held
against that plain path on the card by ``chip_smoke.py``.

Tolerances: sign words and the decode-mean bitwise (elementwise in the
reference); the residual bitwise given the reference's scales; L1, L2²,
scales and densities to rtol 1e-5 (fp32 sums over up to 65,536 terms,
taken in another order by XLA and by PyTorch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jC
from repro.kernels import ef_sign as jef_sign
from repro.kernels import ops as jops
from repro_torch.core import compressors as C
from repro_torch.kernels import ef_sign, ops, ref

SUM_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite runs beside other test workers; tiny tensors need no more
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _buckets(nb: int, bs: int, seed: int):
    """(g, e) with edge rows: 0 all zero, 1 with −0.0, 2 with NaN."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(nb, bs)).astype(np.float32)
    e = (rng.normal(size=(nb, bs)) * 0.1).astype(np.float32)
    g[0], e[0] = 0.0, 0.0
    g[1, ::3], e[1, ::3] = -0.0, -0.0
    g[2, ::7] = np.nan
    return g, e


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _assert_bitwise(got: np.ndarray, want: np.ndarray):
    """Equal bits, except that any NaN matches any NaN."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.int32)[~nan], want.view(np.int32)[~nan])


def _words_u32(words: torch.Tensor) -> np.ndarray:
    assert words.dtype == torch.int32
    return words.numpy().view(np.uint32)


BUCKET_SIZES = [96, 4096, 65536]  # 96: a multiple of 32 but not of 4096


@pytest.mark.parametrize("bs", BUCKET_SIZES)
def test_bucket_stats_matches_pallas(bs):
    g, e = _buckets(4, bs, bs)
    l1, l2 = [np.asarray(x) for x in jef_sign.bucket_stats(jnp.asarray(g), jnp.asarray(e), interpret=True)]
    p1, p2 = ref.bucket_stats_ref(_t(g), _t(e))
    np.testing.assert_allclose(p1.numpy(), l1, rtol=SUM_RTOL)
    np.testing.assert_allclose(p2.numpy(), l2, rtol=SUM_RTOL)
    assert p1[0] == 0 and p2[0] == 0 and torch.isnan(p1[2])


@pytest.mark.parametrize("bs", BUCKET_SIZES)
def test_bucket_ef_sign_compress_matches_pallas(bs):
    g, e = _buckets(4, bs, bs + 1)
    l1, _ = jef_sign.bucket_stats(jnp.asarray(g), jnp.asarray(e), interpret=True)
    scales = np.asarray(l1 / float(bs))
    jw, je = jef_sign.bucket_ef_sign_compress(
        jnp.asarray(g), jnp.asarray(e), jnp.asarray(scales), interpret=True
    )
    pw, pe = ref.bucket_ef_sign_compress_ref(_t(g), _t(e), _t(scales))
    np.testing.assert_array_equal(_words_u32(pw), np.asarray(jw))
    _assert_bitwise(pe.numpy(), np.asarray(je))
    # the all-zero bucket packs to all ones; −0.0 packs as 1, NaN as 0
    assert (_words_u32(pw)[0] == 0xFFFFFFFF).all()
    bits = (_words_u32(pw)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.reshape(4, bs)
    assert (bits[1, ::3] == 1).all() and (bits[2, ::7] == 0).all()


def _payloads(w: int, nb: int, m: int, seed: int):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(w, nb, m), dtype=np.uint32)
    scales = rng.random((w, nb)).astype(np.float32)
    return words, scales


@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_decompress_mean_matches_pallas(w):
    words, scales = _payloads(w, 3, 128, w)
    want = jef_sign.bucket_sign_decompress_mean(jnp.asarray(words), jnp.asarray(scales), interpret=True)
    got = ops.bucket_decompress_mean(_t(words.view(np.int32)), _t(scales))
    _assert_bitwise(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w", [1, 2, 3, 8, 70])
def test_decompress_mean_matches_reference_ops(w):
    # 70 senders crosses the reference's unroll cap (ref.py:20): its
    # fori_loop keeps the same accumulation order, and so does the port
    words, scales = _payloads(w, 3, 3, 100 + w)
    want = jops.bucket_decompress_mean(jnp.asarray(words), jnp.asarray(scales), force="ref")
    got = ops.bucket_decompress_mean(_t(words.view(np.int32)), _t(scales))
    _assert_bitwise(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fixed_scale", [None, 0.25])
@pytest.mark.parametrize("bs", BUCKET_SIZES)
def test_ef_sign_bucket_step_matches_reference_ops(bs, fixed_scale):
    g, e = _buckets(5, bs, 7 * bs)
    jw, js, je, jd = [
        np.asarray(x)
        for x in jops.ef_sign_bucket_step(
            jnp.asarray(g), jnp.asarray(e), fixed_scale=fixed_scale, force="ref"
        )
    ]
    pw, ps, pe, pd = ops.ef_sign_bucket_step(_t(g), _t(e), fixed_scale=fixed_scale)
    np.testing.assert_array_equal(_words_u32(pw), jw)
    np.testing.assert_allclose(ps.numpy(), js, rtol=SUM_RTOL)
    np.testing.assert_allclose(pd.numpy(), jd, rtol=SUM_RTOL)
    assert pd[0] == 1.0  # L2² = 0 → density 1
    # given the reference's scales the residual is bitwise
    _, pe_given = ref.bucket_ef_sign_compress_ref(_t(g), _t(e), _t(js))
    _assert_bitwise(pe_given.numpy(), je)
    # with its own scales: ±scale terms that can cancel, so rtol of the scale
    np.testing.assert_allclose(pe.numpy(), je, rtol=SUM_RTOL, atol=SUM_RTOL * np.nanmax(js))


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ef_sign.reset_launch_counts()
    g, e = _buckets(3, 128, 0)
    ops.ef_sign_bucket_step(_t(g), _t(e))
    ops.bucket_decompress_mean(torch.zeros((2, 3, 4), dtype=torch.int32), torch.ones((2, 3)))
    assert [k.launches for k in ef_sign.KERNELS] == [0, 0, 0]


def test_kernel_wrappers_refuse_cpu_tensors():
    g = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        ef_sign.bucket_stats(g, g)
    with pytest.raises(ValueError, match="CUDA"):
        ef_sign.bucket_ef_sign_compress(g, g, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        ef_sign.bucket_sign_decompress_mean(torch.zeros((1, 2, 2), dtype=torch.int32), torch.zeros((1, 2)))
    with pytest.raises(ValueError, match="device"):
        ops.ef_sign_bucket_step(g.to("meta"), g.to("meta"))
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.ef_sign_bucket_step(torch.zeros((2, 48)), torch.zeros((2, 48)))


@pytest.mark.parametrize("n", [64, 65, 95])  # n % 32 ∈ {0, 1, 31}
def test_pack_signs_matches_reference(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=n).astype(np.float32)
    x[::5], x[1::7] = -0.0, np.nan
    want = np.asarray(jC.pack_signs(jnp.asarray(x)))
    got = _words_u32(C.pack_signs(_t(x)))
    np.testing.assert_array_equal(got, want)
    if n % 32:
        assert not (got[-1] >> np.uint32(n % 32)).any(), "padding bits must be zero"


@pytest.mark.parametrize("name", ["scaled_sign", "sign"])
def test_compressor_wire_bits_match_reference(name):
    jc, pc = jC.get_compressor(name), C.get_compressor(name)
    for n in (32, 97, 4096, 65536):
        assert pc.wire_bits(n) == jc.wire_bits(n)
    with pytest.raises(ValueError, match="not ported"):
        C.get_compressor("top_k")
