"""The port's training slice against the JAX package, on the CPU.

Five steps of ``run_training`` on the reduced llama with ``ef_allgather``,
``scaled_sign``, bucket 4096, sgd at a constant lr, batch 4, seq 32 — the
same explicit batches and the same initial parameters (the reference's own
``init_params``, carried over) on both sides — at W = 1 (the JAX run
in-process on a 1-device mesh) and W = 2 (in a subprocess with two host
devices).

* The losses agree to rtol 1e-4 at every step (fp32 sums in another order).
* At step 1 at most 1e-4 of the sign bits differ: a sign can tie-break
  differently only where |p| is near 0, after gradients that differ in the
  last bits.
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

from repro.comm import bucketize as jbucketize
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import optim as jopt
from repro.kernels import ops as jops
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as jtransformer
from repro.train.loop import TrainJob as JTrainJob
from repro.train.loop import run_training as jrun_training
from repro_torch.comm import bucketize
from repro_torch.configs import get_config, reduced
from repro_torch.core import optim
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import tree_paths
from repro_torch.train import loop
from repro_torch.train.steps import grad_fn, split_workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH, SEQ, BS, LR, SEED = 5, 4, 32, 4096, 0.02, 0
LOSS_RTOL, MAX_BIT_FLIPS = 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batches(vocab: int) -> list[dict]:
    rng = np.random.default_rng(1234)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, size=(BATCH, SEQ + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _jax_reference(world: int, batches: list[dict]) -> dict:
    """The reference's 5-step run plus its step-1 sign words, per worker."""
    cfg = jreduced(jget_config("llama3_2_1b"))
    params0 = jtransformer.init_params(cfg, jax.random.PRNGKey(SEED))
    job = JTrainJob(
        cfg=cfg, mesh=make_host_mesh(data=world, model=1), steps=STEPS, batch=BATCH, seq=SEQ,
        lr=LR, optimizer="sgd", strategy="ef_allgather", compressor="scaled_sign",
        bucket_size=BS, lr_schedule="constant", log_every=1, seed=SEED,
    )
    it = ({k: jnp.asarray(v) for k, v in b.items()} for b in batches)
    state, history = jrun_training(job, it)
    # step-1 words: each worker's update of the first step, as the step
    # computes it (loss grad on its shard, -lr scaling, buckets, EF encode
    # against a zero residual)
    layout = jbucketize.build_layout(params0, BS)
    words = []
    for i in range(world):
        shard = {k: jnp.asarray(v.reshape(world, BATCH // world, SEQ)[i]) for k, v in batches[0].items()}
        grads = jax.grad(lambda p: jtransformer.loss_fn(p, cfg, shard)[0])(params0)
        upd, _ = jopt.sgd(LR).update(grads, jopt.sgd(LR).init(params0), params0)
        (b,) = jbucketize.flatten_buckets(layout, upd)
        words.append(np.asarray(jops.ef_sign_bucket_step(b, jnp.zeros_like(b), force="ref")[0]))
    out = {
        "losses": np.asarray([r["loss"] for r in history], np.float64),
        "wire": np.asarray([r["wire_bytes"] for r in history], np.float64),
        "words": np.stack(words),
    }
    for tag, tree in (("params0", params0), ("params", state.params)):
        for path, leaf in tree_paths(jax.device_get(tree)):
            out[f"{tag}:{path}"] = np.asarray(leaf)
    return out


def _tree(ref: dict, tag: str) -> dict[str, torch.Tensor]:
    """The port's parameter dict from the ``tag:path`` entries of a reference run."""
    return {k.split(":", 1)[1]: torch.from_numpy(np.array(v)) for k, v in ref.items()
            if k.startswith(tag + ":")}


def _port_run(world: int, batches: list[dict], params0: dict[str, torch.Tensor]) -> dict:
    cfg = reduced(get_config("llama3.2-1b"))
    job = loop.TrainJob(
        cfg=cfg, world=world, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR, optimizer="sgd",
        strategy="ef_allgather", compressor="scaled_sign", bucket_size=BS,
        lr_schedule="constant", log_every=1, seed=SEED,
    )
    start = {k: v.clone() for k, v in params0.items()}
    it = ({k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()} for b in batches)
    state, history = loop.run_training(job, it, device="cpu", params=start)
    # step-1 words of each worker, through the port's step functions
    params = params0
    layout = bucketize.build_layout(params, BS)
    batch0 = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batches[0].items()}
    words = []
    for i in range(world):
        _, grads = grad_fn(params, cfg, split_workers(batch0, world, i))
        upd, _ = optim.sgd(LR).update(grads, optim.sgd(LR).init(params), params)
        (b,) = bucketize.flatten_buckets(layout, upd)
        words.append(ops.ef_sign_bucket_step(b, torch.zeros_like(b))[0].numpy().view(np.uint32))
    return {
        "losses": np.asarray([r["loss"] for r in history]),
        "wire": np.asarray([r["wire_bytes"] for r in history]),
        "params": state.params,
        "words": np.stack(words),
    }


_W2_DRIVER = r"""
import os, sys
sys.path[:0] = [os.path.join(%(repo)r, "src"), os.path.join(%(repo)r, "tests")]
import numpy as np
import test_torch_train as t
data = np.load(%(inp)r)
batches = [{"tokens": x, "labels": y} for x, y in zip(data["tokens"], data["labels"])]
np.savez(%(out)r, **t._jax_reference(2, batches))
"""


def _reference(world: int, batches, tmp_path) -> dict:
    if world == 1:
        return _jax_reference(1, batches)
    inp, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(inp, tokens=np.stack([b["tokens"] for b in batches]),
             labels=np.stack([b["labels"] for b in batches]))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={world}"}
    proc = subprocess.run([sys.executable, "-c", _W2_DRIVER % {"repo": REPO, "inp": inp, "out": out}],
                          capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("world", [1, 2])
def test_five_step_trajectory_matches_reference(world, tmp_path):
    batches = _batches(1024)
    want = _reference(world, batches, tmp_path)
    got = _port_run(world, batches, _tree(want, "params0"))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got["wire"], want["wire"])
    flips = np.unpackbits((got["words"] ^ want["words"]).view(np.uint8)).sum()
    assert flips <= MAX_BIT_FLIPS * got["words"].size * 32, f"{flips} sign bits differ at step 1"
    final = _tree(want, "params")
    dmax = max(float((got["params"][k] - final[k]).abs().max()) for k in final)
    scale = max(float(final[k].abs().max()) for k in final)
    print(f"W={world}: losses {got['losses'].tolist()} step-1 bit flips {flips}; "
          f"final max |dparam| {dmax:.3e} (params up to {scale:.3e})")


def test_run_training_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = loop.TrainJob(cfg=reduced(get_config("llama3.2-1b")), steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.run_training(job)
    assert loop.resolve_device("cpu") == torch.device("cpu")


def test_launcher_runs_on_cpu_when_asked(capsys):
    launch_train.main([
        "--arch", "llama3.2-1b", "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
        "--mesh-data", "2", "--bucket-size", "4096", "--device", "cpu",
    ])
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(x) for x in lines[:-1]]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["wire_bytes"] > 0 for r in recs)
    assert lines[-1].startswith("final_loss=")


def test_unported_options_raise():
    cfg = reduced(get_config("llama3.2-1b"))
    with pytest.raises(NotImplementedError, match="not ported"):
        loop.run_training(loop.TrainJob(cfg=cfg, optimizer="adam", steps=1), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        loop.run_training(loop.TrainJob(cfg=cfg, strategy="dense", steps=1), device="cpu")


def _rule_fraction(toks: np.ndarray, labels: np.ndarray, vocab: int) -> float:
    """Share of positions whose token is (31·t₋₁ + 17·t₋₂ + 7) mod vocab."""
    full = np.concatenate([toks, labels[:, -1:]], axis=1).astype(np.int64)
    rule = (31 * full[:, :-2] + 17 * full[:, 1:-1] + 7) % vocab
    return float((full[:, 2:] == rule).mean())


def test_token_batches_follow_the_reference_construction():
    from repro.data import synthetic as jsynthetic

    b = synthetic.token_batch(torch.Generator().manual_seed(0), 64, 256, 1024)
    toks, labels = b["tokens"], b["labels"]
    assert toks.shape == labels.shape == (64, 256)
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    assert int(toks.min()) >= 0 and int(toks.max()) < 1024
    # another generator, so compare in distribution with the reference
    jb = jsynthetic.token_batch(jax.random.PRNGKey(0), 64, 256, 1024)
    got = _rule_fraction(toks.numpy(), labels.numpy(), 1024)
    want = _rule_fraction(np.asarray(jb["tokens"]), np.asarray(jb["labels"]), 1024)
    assert abs(got - want) < 0.01, (got, want)
    first = next(synthetic.token_batches(3, 2, 8, 100))
    again = next(synthetic.token_batches(3, 2, 8, 100))
    assert all(torch.equal(first[k], again[k]) for k in first)


@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.9, 5e-4)])
def test_sgd_chain_matches_reference(momentum, wd):
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=7).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in tree.items()} for _ in range(3)]
    jt = jopt.sgd(jopt.step_decay_schedule(0.1, 4), momentum=momentum, weight_decay=wd)
    pt = optim.sgd(optim.step_decay_schedule(0.1, 4), momentum=momentum, weight_decay=wd)
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    pparams = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    js, ps = jt.init(jparams), pt.init(pparams)
    for g in grads:
        ju, js = jt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jparams)
        pu, ps = pt.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, ps, pparams)
        jparams = jopt.apply_updates(jparams, ju)
        optim.apply_updates(pparams, pu)
        for k in tree:
            np.testing.assert_allclose(pparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["constant", "step_decay", "cosine"])
def test_schedules_match_reference(name):
    jsched = {"constant": jopt.constant_schedule(0.02), "step_decay": jopt.step_decay_schedule(0.02, 10),
              "cosine": jopt.cosine_schedule(0.02, 10, warmup=2)}[name]
    psched = {"constant": optim.constant_schedule(0.02), "step_decay": optim.step_decay_schedule(0.02, 10),
              "cosine": optim.cosine_schedule(0.02, 10, warmup=2)}[name]
    for step in range(12):
        np.testing.assert_allclose(psched(step), float(jsched(jnp.int32(step))), rtol=1e-6)
