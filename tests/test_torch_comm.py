"""The port's bucketed comm layer against the JAX package, on the CPU.

* Bucketize: on the reduced llama parameter tree the port's buckets must be
  the reference's bitwise — the leaf-order contract every per-bucket scale
  rests on.
* The ``ef_allgather`` aggregator: on the same per-worker bucket stacks and
  residuals, the port's words must equal the reference's encode bitwise; the
  mean update, new residuals and scales agree to rtol 1e-5 (per-bucket L1
  sums in another order); ``wire_bytes`` is exactly the reference's. W = 1
  runs the JAX aggregator in-process on a 1-device mesh, W = 2 in a
  subprocess with two host devices.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommSpec, make_aggregator
from repro.comm import bucketize as jbucketize
from repro.comm import compressed as jcompressed
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import compressors as jC
from repro.launch.mesh import make_host_mesh, use_mesh
from repro.models import transformer as jtransformer
from repro_torch.comm import bucketize, compressed
from repro_torch.comm.collective import BucketedAggregator
from repro_torch.core import aggregation
from repro_torch.core import compressors as C
from repro_torch.models.convert import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llama_tree():
    cfg = jreduced(jget_config("llama3_2_1b"))
    return jax.device_get(jtransformer.init_params(cfg, jax.random.PRNGKey(0)))


def test_bucket_contents_match_reference_bitwise(llama_tree):
    jlayout = jbucketize.build_layout(llama_tree, 4096)
    want = [np.asarray(b) for b in jbucketize.flatten_buckets(jlayout, llama_tree)]
    params = from_jax_params(llama_tree)
    layout = bucketize.build_layout(params, 4096)
    got = bucketize.flatten_buckets(layout, params)
    assert [(g.valid, g.n_buckets) for g in layout.groups] == [
        (g.valid, g.n_buckets) for g in jlayout.groups
    ]
    assert [(s.offset, s.size, s.shape) for s in layout.slots] == [
        (s.offset, s.size, s.shape) for s in jlayout.slots
    ]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_unflatten_roundtrip_exact_and_padding_zero(llama_tree):
    params = from_jax_params(llama_tree)
    layout = bucketize.build_layout(params, 4096)
    (buckets,) = bucketize.flatten_buckets(layout, params)
    (group,) = layout.groups
    assert group.n_buckets * 4096 > group.valid
    assert not buckets.view(-1)[group.valid :].any(), "padding must be zero"
    back = bucketize.unflatten_buckets(layout, (buckets,))
    assert list(back) == list(params)
    for k in params:
        assert torch.equal(back[k], params[k])
    mask = bucketize.valid_mask(layout, 0)
    want = np.asarray(jbucketize.valid_mask(jbucketize.build_layout(llama_tree, 4096), 0))
    np.testing.assert_array_equal(mask.numpy(), want)


def test_layout_rejects_bad_bucket_sizes_and_orders(llama_tree):
    params = from_jax_params(llama_tree)
    with pytest.raises(ValueError, match="multiple of 32"):
        bucketize.build_layout(params, 100)
    layout = bucketize.build_layout(params, 4096)
    shuffled = dict(reversed(list(params.items())))
    with pytest.raises(ValueError, match="order"):
        bucketize.flatten_buckets(layout, shuffled)


# ---------------------------------------------------------------------------
# the ef_allgather aggregator against the reference's
# ---------------------------------------------------------------------------

TREE_SHAPES = {"a": (700,), "b": (37, 11)}  # 1107 elements: 9 buckets of 128
BS = 128


def _agg_inputs(world: int, seed: int):
    rng = np.random.default_rng(seed)
    nb = -(-sum(int(np.prod(s)) for s in TREE_SHAPES.values()) // BS)
    buckets = rng.normal(size=(world, nb, BS)).astype(np.float32)
    err = (rng.normal(size=(world, nb, BS)) * 0.1).astype(np.float32)
    buckets[0, 0, :32] = 0.0  # a word of exact zeros packs to all ones
    return buckets, err


def _jax_aggregate(world: int, comp_name: str, buckets, err) -> dict:
    """The reference on ``world`` host devices: aggregator outputs plus each
    worker's payload from the reference's encode."""
    mesh = make_host_mesh(data=world, model=1)
    tree = {k: jnp.zeros(s, jnp.float32) for k, s in TREE_SHAPES.items()}
    layout = jbucketize.build_layout(tree, BS)
    comp = jC.get_compressor(comp_name)
    with use_mesh(mesh):
        agg = make_aggregator(CommSpec(strategy="ef_allgather", compressor=comp, bucket_size=BS),
                              layout, mesh, ("data",))
        out, new_err, _, info = jax.jit(agg)(
            (jnp.asarray(buckets),), (jnp.asarray(err),), (), jax.random.PRNGKey(0)
        )
    mask = jbucketize.valid_mask(layout, 0)
    words, scales = [], []
    for i in range(world):
        payload, _, _ = jcompressed.ef_encode_buckets(
            comp, jnp.asarray(buckets[i]), jnp.asarray(err[i]), mask=mask
        )
        words.append(np.asarray(payload.data["words"]))
        scales.append(np.asarray(payload.data["scale"]))
    return {
        "mean": np.asarray(out[0]),
        "err": np.asarray(new_err[0]),
        "words": np.stack(words),
        "scales": np.stack(scales),
        "wire_bytes": float(info.wire_bytes_per_device),
        "density": float(info.mean_density),
    }


def _port_aggregate(world: int, comp_name: str, buckets, err) -> dict:
    params = {k: torch.zeros(s) for k, s in TREE_SHAPES.items()}
    layout = bucketize.build_layout(params, BS)
    agg = BucketedAggregator("ef_allgather", C.get_compressor(comp_name), layout, world)
    err_t = torch.from_numpy(err.copy())
    messages = [agg.encode([torch.from_numpy(buckets[i].copy())], [err_t[i]]) for i in range(world)]
    (mean,), info = agg.reduce(messages)
    return {
        "mean": mean.numpy(),
        "err": err_t.numpy(),
        "words": np.stack([m.payloads[0].data["words"].numpy().view(np.uint32) for m in messages]),
        "scales": np.stack([m.payloads[0].data["scale"].numpy() for m in messages]),
        "wire_bytes": info.wire_bytes_per_device,
        "density": float(info.mean_density),
        "nb": layout.n_buckets,
    }


def _assert_aggregates_match(got: dict, want: dict):
    np.testing.assert_array_equal(got["words"], want["words"])
    np.testing.assert_allclose(got["scales"], want["scales"], rtol=RTOL)
    # the mean and the residual are sums of ±scale terms that can cancel:
    # their error is rtol of the largest term, not of the (possibly ~0) result
    atol = RTOL * float(np.abs(want["scales"]).max())
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=RTOL, atol=atol)
    np.testing.assert_allclose(got["err"], want["err"], rtol=RTOL, atol=atol)
    assert got["wire_bytes"] == want["wire_bytes"]
    np.testing.assert_allclose(got["density"], want["density"], rtol=RTOL)


@pytest.mark.parametrize("comp_name", ["scaled_sign", "sign"])
def test_aggregator_matches_reference_w1(comp_name):
    buckets, err = _agg_inputs(1, 11)
    got = _port_aggregate(1, comp_name, buckets, err)
    _assert_aggregates_match(got, _jax_aggregate(1, comp_name, buckets, err))
    assert got["wire_bytes"] == 0.0
    # the padded tail of the residual stays zero
    assert not got["err"].reshape(-1)[1107:].any()


_W2_DRIVER = r"""
import os, sys, json
sys.path[:0] = [os.path.join(%(repo)r, "src"), os.path.join(%(repo)r, "tests")]
import numpy as np
import test_torch_comm as t
data = np.load(%(inp)r)
out = t._jax_aggregate(2, "scaled_sign", data["buckets"], data["err"])
np.savez(%(out)r, **{k: np.asarray(v) for k, v in out.items()})
print(json.dumps({"ok": True}))
"""


def _run_jax_subprocess(code: str, world: int) -> None:
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={world}",
    }
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env=env
    )
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_aggregator_matches_reference_w2(tmp_path):
    buckets, err = _agg_inputs(2, 12)
    inp, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(inp, buckets=buckets, err=err)
    _run_jax_subprocess(_W2_DRIVER % {"repo": REPO, "inp": inp, "out": out}, 2)
    want = {k: v[()] if v.ndim == 0 else v for k, v in np.load(out).items()}
    got = _port_aggregate(2, "scaled_sign", buckets, err)
    _assert_aggregates_match(got, want)
    assert got["wire_bytes"] == aggregation.bucketed_sign_allgather_wire_bytes(got["nb"], BS, 2)


def test_encode_masks_padding_like_valid_mask():
    rng = np.random.default_rng(5)
    b = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    comp = C.ScaledSignCompressor()
    _, masked, _ = compressed.ef_encode_buckets(comp, b, e, valid=150)
    _, plain, _ = compressed.ef_encode_buckets(comp, b, e)
    mask = (torch.arange(192) < 150).float().view(3, 64)
    assert torch.equal(masked.view(torch.int32), (plain * mask).view(torch.int32))


def test_aggregator_rejects_what_is_not_ported():
    layout = bucketize.build_layout({"a": torch.zeros(64)}, 32)
    with pytest.raises(NotImplementedError, match="not ported"):
        BucketedAggregator("ef_ring", C.ScaledSignCompressor(), layout, 2)
    agg = BucketedAggregator("ef_allgather", C.ScaledSignCompressor(), layout, 2)
    with pytest.raises(ValueError, match="world"):
        agg.reduce([])
