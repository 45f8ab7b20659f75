"""The port's training substrate against the reference's, on the CPU:
the synthetic corpus (bitwise), the AdamW schedule, error-feedback int8
compression (the same codes), the optimizer on a quadratic, and the
checkpointer's on-disk contract (bf16 roundtrip, GC, the manifest, an
unfinished step ignored, a failed save raised)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticCorpus as JCorpus  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.data import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.optim import OptConfig, adamw  # noqa: E402


# ------------------------------------------------------------------- data --
@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (97, 32, 8, 1234), (512, 64, 4, 0), (32064, 256, 4, 0)])
def test_corpus_batches_bitwise_reference(vocab, seq, batch, seed):
    got = SyntheticCorpus(DataConfig(vocab, seq, batch, seed=seed))
    want = JCorpus(JDataConfig(vocab, seq, batch, seed=seed))
    for step in (0, 3):
        g, w = got.batch(step), want.batch(step)
        assert sorted(g) == sorted(w) == ["positions", "targets", "tokens"]
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    g = got.batch(2, shard=1, num_shards=2)
    w = want.batch(2, shard=1, num_shards=2)
    np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_data_deterministic_and_sharded():
    c = SyntheticCorpus(DataConfig(vocab_size=97, seq_len=32,
                                   global_batch=8))
    b1 = c.batch(3)
    np.testing.assert_array_equal(b1["tokens"], c.batch(3)["tokens"])
    s0 = c.batch(3, shard=0, num_shards=2)
    s1 = c.batch(3, shard=1, num_shards=2)
    np.testing.assert_array_equal(
        np.concatenate([s0["tokens"], s1["tokens"]]), b1["tokens"])
    assert (b1["tokens"] < 97).all() and (b1["tokens"] >= 0).all()
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])


# -------------------------------------------------------------- optimizer --
@pytest.mark.parametrize("cfg", [
    OptConfig(), OptConfig(peak_lr=3e-3, min_lr=3e-4, warmup_steps=2,
                           total_steps=14),
    OptConfig(warmup_steps=0, total_steps=5)])
def test_schedule_matches_reference(cfg):
    jcfg = jadamw.OptConfig(**{k: getattr(cfg, k) for k in (
        "peak_lr", "min_lr", "warmup_steps", "total_steps")})
    steps = [0, 1, 2, 3, 7, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000]
    got = [float(adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(jadamw.schedule(jcfg, s)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(adamw.schedule(cfg, 3)) == got[3]


def test_compression_gives_the_reference_codes():
    """The same dequantised values and errors, so the same int8 codes,
    over several steps of feedback."""
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((33, 7)).astype(np.float32),
         "b": (rng.standard_normal(64) * 1e-3).astype(np.float32),
         "z": np.zeros(5, np.float32)}
    terr = {k: torch.zeros(v.shape) for k, v in g.items()}
    jerr = {k: jnp.zeros(v.shape) for k, v in g.items()}
    for i in range(4):
        gi = {k: v * (1 + 0.3 * i) for k, v in g.items()}
        tdeq, terr = adamw.compress_decompress(
            {k: torch.from_numpy(v) for k, v in gi.items()}, terr)
        jdeq, jerr = jadamw.compress_decompress(
            {k: jnp.asarray(v) for k, v in gi.items()}, jerr)
        for k in g:
            np.testing.assert_array_equal(tdeq[k].numpy(),
                                          np.asarray(jdeq[k]), err_msg=k)
            np.testing.assert_array_equal(terr[k].numpy(),
                                          np.asarray(jerr[k]), err_msg=k)


def test_error_feedback_compression_telescopes():
    g = torch.from_numpy(np.linspace(-3, 7, 64).astype(np.float32))
    err = {"w": torch.zeros(64)}
    total_true = np.zeros(64)
    total_sent = np.zeros(64)
    for i in range(30):
        gi = {"w": g * (1 + 0.1 * i)}
        total_true += gi["w"].numpy()
        deq, err = adamw.compress_decompress(gi, err)
        total_sent += deq["w"].numpy()
    assert np.max(np.abs(total_true - total_sent)) < 0.2


def test_adamw_reduces_quadratic_and_keeps_bf16():
    params = {"w": torch.full((4,), 5.0, dtype=torch.bfloat16)}
    oc = OptConfig(peak_lr=0.5, min_lr=0.05, warmup_steps=1,
                   total_steps=60, weight_decay=0.0)
    state = adamw.init_state(params)
    assert state["master"]["w"].dtype == torch.float32
    assert state["step"].dtype == torch.int32
    for _ in range(60):
        grads = {"w": state["master"]["w"] * 2.0}
        params, state, _, stats = adamw.apply_updates(oc, state, params,
                                                      grads)
    assert float(state["master"]["w"].abs().max()) < 0.3
    assert params["w"].dtype == torch.bfloat16
    assert int(state["step"]) == 60 and float(stats["grad_norm"]) >= 0


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((8, 8)).astype(np.float32) * 3,
            "b": rng.standard_normal(16).astype(np.float32)}
    got = float(adamw.global_norm({k: torch.from_numpy(v)
                                   for k, v in tree.items()}))
    want = float(jadamw.global_norm({k: jnp.asarray(v)
                                     for k, v in tree.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="error-feedback"):
        p = {"w": torch.zeros(2)}
        adamw.apply_updates(OptConfig(compress_grads=True),
                            adamw.init_state(p), p, {"w": torch.ones(2)})


# -------------------------------------------------------------- checkpoint --
def _state():
    return {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) / 3,
            "nested": {"b": torch.ones(3),
                       "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    ck.save(5, state, blocking=True)
    like = {"a": torch.zeros(2, 3, dtype=torch.bfloat16),
            "nested": {"b": torch.zeros(3),
                       "step": torch.tensor(0, dtype=torch.int32)}}
    step, restored = ck.restore(like)
    assert step == 5 and restored is like
    assert torch.equal(restored["a"], state["a"])
    assert restored["a"].dtype == torch.bfloat16
    assert int(restored["nested"]["step"]) == 7
    assert restored["nested"]["step"].dtype == torch.int32
    # the reference's layout: a shard of /-joined keys, bf16 stored f32
    path = tmp_path / "step_00000005"
    with np.load(path / "shard_0.npz") as data:
        assert sorted(data.files) == ["a", "nested/b", "nested/step"]
        assert data["a"].dtype == np.float32
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["step"] == 5
    assert manifest["keys"] == ["a", "nested/b", "nested/step"]
    assert not (path / "manifest.json.tmp").exists()


def test_checkpoint_gc_keeps_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ck.save(s, state, blocking=True)
    assert ck.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]


def test_checkpoint_snapshot_and_incomplete_steps(tmp_path):
    """save() snapshots before it returns (later in-place updates do not
    reach the file); a step without a manifest is not a checkpoint; a
    failed write raises from wait()."""
    ck = Checkpointer(str(tmp_path))
    state = {"x": torch.zeros(3)}
    ck.save(1, state)
    state["x"].add_(5.0)
    ck.wait()
    os.makedirs(tmp_path / "step_00000009")
    assert ck.latest_step() == 1
    like = {"x": torch.ones(3)}
    ck.restore(like)
    assert torch.equal(like["x"], torch.zeros(3))
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(like)
    (tmp_path / "step_00000002").write_text("in the way")
    ck.save(2, state)
    with pytest.raises(FileExistsError):
        ck.wait()
    assert ck.latest_step() == 1


def test_checkpoint_files_cross_read_with_the_reference(tmp_path):
    """Either package restores the other's checkpoint: one format."""
    from repro.checkpoint import Checkpointer as JCheckpointer
    state = _state()
    Checkpointer(str(tmp_path / "t")).save(3, state, blocking=True)
    jlike = {"a": jnp.zeros((2, 3), jnp.bfloat16),
             "nested": {"b": jnp.zeros(3, jnp.float32),
                        "step": jnp.zeros((), jnp.int32)}}
    step, got = JCheckpointer(str(tmp_path / "t")).restore(jlike)
    assert step == 3 and int(got["nested"]["step"]) == 7
    np.testing.assert_array_equal(np.asarray(got["a"], np.float32),
                                  state["a"].float().numpy())

    JCheckpointer(str(tmp_path / "j")).save(4, got, blocking=True)
    like = {"a": torch.zeros(2, 3, dtype=torch.bfloat16),
            "nested": {"b": torch.zeros(3),
                       "step": torch.tensor(0, dtype=torch.int32)}}
    step, _ = Checkpointer(str(tmp_path / "j")).restore(like)
    assert step == 4 and torch.equal(like["a"], state["a"])
    assert torch.equal(like["nested"]["b"], state["nested"]["b"])
