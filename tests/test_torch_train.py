"""The port's training path (``repro_torch.train``, ``optim``,
``checkpoint``, ``data``; gradients through ``models``) against the
reference's, on the CPU.

- Loss, gradients and one AdamW update: reduced f32 ``qwen3-8b`` (dense,
  qk-norm), ``phi3.5-moe-42b-a6.6b`` (the MoE aux term) and
  ``falcon-mamba-7b`` (gradients through the time loop), their weights
  carried from the reference's init by ``params_from_jax`` and their
  batch from the shared synthetic corpus: the loss within 1e-5 relative
  of the reference's ``make_loss_fn`` under ``jax.value_and_grad`` (f32
  sums in another order), every gradient leaf within 1e-4 of its largest
  |value|, and the f32 masters after one ``apply_updates`` on the same
  gradients within 1e-6 (the update is lr-sized).
- The trainer, as the reference's ``tests/test_trainer_integration.py``
  holds its own: the loss decreases, a restart from a checkpoint equals
  a straight run bitwise, two microbatches equal one within 1e-5 (f32),
  compressed gradients still learn.
- ``attn_impl="flash"`` refuses gradients, and the serving paths build
  no graph.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.data import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.models import Model, convert  # noqa: E402
from repro_torch.optim import OptConfig, adamw  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

PARITY = ("qwen3-8b", "phi3.5-moe-42b-a6.6b", "falcon-mamba-7b")
TOL_LOSS = 1e-5          # relative
TOL_GRAD = 1e-4          # of the leaf's largest |value|
TOL_MASTER = 1e-6
B, S = 4, 32


@functools.lru_cache(maxsize=None)
def _parity(arch):
    """Reference and port loss, grads (port names) and the batch, for a
    reduced f32 model with the reference's weights."""
    jcfg = dataclasses.replace(jreg.get(arch).reduced(), dtype="float32")
    cfg = convert.config_from_jax(jcfg)
    params = get_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    batch = SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)).batch(0)

    (jtotal, jmet), jgrads = jax.value_and_grad(
        jts.make_loss_fn(jcfg), has_aux=True)(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))

    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(cfg, tree))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, met = tts.make_loss_fn(cfg)(model, tbatch)
    total.backward()
    tg = {k: p.grad for k, p in model.named_parameters()}
    return dict(jcfg=jcfg, cfg=cfg, params=params, tree=tree,
                jtotal=float(jtotal), jloss=float(jmet["loss"]),
                jaux=float(jmet["aux"]), jgrads=jgrads, jg=jg,
                total=float(total.detach()), loss=float(met["loss"]),
                aux=float(met["aux"]), tg=tg)


@pytest.mark.parametrize("arch", PARITY)
def test_loss_matches_reference(arch):
    r = _parity(arch)
    for got, want in ((r["total"], r["jtotal"]), (r["loss"], r["jloss"])):
        assert abs(got - want) <= TOL_LOSS * abs(want), (got, want)
    if r["cfg"].moe:
        assert r["jaux"] > 0
        assert abs(r["aux"] - r["jaux"]) <= TOL_LOSS * abs(r["jaux"])


@pytest.mark.parametrize("arch", PARITY)
def test_gradients_match_reference(arch):
    r = _parity(arch)
    assert set(r["tg"]) == set(r["jg"])
    for k, want in r["jg"].items():
        got = r["tg"][k]
        assert got is not None, k
        want = want.float().numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= TOL_GRAD * scale, (k, err, scale)


@pytest.mark.parametrize("arch", PARITY)
def test_adamw_update_matches_reference(arch):
    """One apply_updates from a fresh state on the reference's gradients:
    the port's f32 masters and the new params equal the reference's."""
    r = _parity(arch)
    oc = OptConfig(peak_lr=3e-3, min_lr=3e-4, warmup_steps=2,
                   total_steps=14)
    joc = jadamw.OptConfig(**dataclasses.asdict(oc))
    jparams, jstate, _, jstats = jadamw.apply_updates(
        joc, jadamw.init_state(r["params"]), r["params"], r["jgrads"])
    want = convert.params_from_jax(
        r["cfg"], jax.tree.map(np.asarray, jstate["master"]))

    model = Model(r["cfg"], device="cpu")
    model.load_state_dict(convert.params_from_jax(r["cfg"], r["tree"]))
    params = dict(model.named_parameters())
    state = adamw.init_state(params)
    params, state, _, stats = adamw.apply_updates(oc, state, params,
                                                  r["jg"])
    assert int(state["step"]) == 1
    np.testing.assert_allclose(float(stats["lr"]), float(jstats["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(stats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-5)
    for k, w in want.items():
        np.testing.assert_allclose(state["master"][k].numpy(), w.numpy(),
                                   atol=TOL_MASTER, rtol=0, err_msg=k)
        np.testing.assert_array_equal(params[k].detach().numpy(),
                                      state["master"][k].numpy())


# ------------------------------------------------------------- trainer --

def _tc(tmp, **kw):
    d = dict(seq_len=32, global_batch=4, steps=14, checkpoint_every=7,
             checkpoint_dir=str(tmp), log_every=1000, device="cpu")
    d.update(kw)
    return TrainConfig(**d)


def _oc(**kw):
    d = dict(peak_lr=3e-3, min_lr=3e-4, warmup_steps=2, total_steps=14)
    d.update(kw)
    return OptConfig(**d)


def test_loss_decreases(tmp_path):
    out = Trainer(get("qwen3-8b").reduced(), _tc(tmp_path / "b"),
                  _oc()).run()
    h = out["history"]
    assert h[-1]["loss"] < h[0]["loss"]
    assert all(np.isfinite(x["loss"]) and x["grad_norm"] > 0 for x in h)


def test_restart_matches_straight_run(tmp_path):
    """Killed after step 7 and restarted from its checkpoint, the run
    ends bitwise where the straight run ends: loss, params, optimizer."""
    cfg = get("qwen3-8b").reduced()
    a = Trainer(cfg, _tc(tmp_path / "x"), _oc()).run()
    Trainer(cfg, _tc(tmp_path / "y"), _oc()).run(steps=7)
    b = Trainer(cfg, _tc(tmp_path / "y"), _oc()).run(steps=14)
    assert b["history"][0]["step"] == 7
    assert b["history"][-1]["loss"] == a["history"][-1]["loss"]
    sa, sb = a["state"], b["state"]
    assert int(sa["opt"]["step"]) == int(sb["opt"]["step"]) == 14
    for k, p in sa["params"].items():
        assert torch.equal(p, sb["params"][k]), k
        for part in ("m", "v", "master"):
            assert torch.equal(sa["opt"][part][k], sb["opt"][part][k]), k


def test_microbatch_equivalence(tmp_path):
    """Two microbatches accumulate f32 gradients to the one-batch step's
    (f32 model: the sums differ in order only)."""
    cfg = dataclasses.replace(get("phi3-mini-3.8b").reduced(),
                              dtype="float32")
    a = Trainer(cfg, _tc(tmp_path / "m1", steps=4, microbatches=1),
                _oc(total_steps=4)).run()
    b = Trainer(cfg, _tc(tmp_path / "m2", steps=4, microbatches=2),
                _oc(total_steps=4)).run()
    for ha, hb in zip(a["history"], b["history"]):
        np.testing.assert_allclose(hb["loss"], ha["loss"], rtol=1e-5)
    for k, p in a["state"]["opt"]["master"].items():
        np.testing.assert_allclose(b["state"]["opt"]["master"][k].numpy(),
                                   p.numpy(), atol=1e-5, err_msg=k)


def test_microbatches_split_positions3(tmp_path):
    """M-RoPE's (3, B, S) positions split along B, as the reference's."""
    x = torch.arange(3 * 4 * 5).reshape(3, 4, 5)
    got = tts._split("positions3", x, 2)
    want = np.asarray(x.numpy()).reshape(3, 2, 2, 5).transpose(1, 0, 2, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    cfg = get("qwen2-vl-7b").reduced()
    out = Trainer(cfg, _tc(tmp_path / "v", steps=2, microbatches=2),
                  _oc(total_steps=2)).run()
    assert all(np.isfinite(h["loss"]) for h in out["history"])


def test_compressed_gradients_still_learn(tmp_path):
    cfg = get("qwen3-8b").reduced()
    out = Trainer(cfg, _tc(tmp_path / "c", steps=14),
                  _oc(compress_grads=True)).run()
    h = out["history"]
    assert h[-1]["loss"] < h[0]["loss"]
    assert out["state"]["err"] is not None


def test_every_family_trains_a_step(tmp_path):
    """One step of each family the reference trains: finite loss, and
    every parameter reached by a gradient (whisper's audio stub, the
    hybrid's two mixers, MLA, the MoE experts)."""
    for arch in ("whisper-large-v3", "recurrentgemma-2b",
                 "deepseek-v2-lite-16b"):
        tr = Trainer(get(arch).reduced(),
                     _tc(tmp_path / arch, steps=1), _oc(total_steps=1))
        out = tr.run()
        assert np.isfinite(out["history"][0]["loss"]), arch
        assert int(out["state"]["opt"]["step"]) == 1


def test_flash_refuses_gradients():
    cfg = dataclasses.replace(get("phi3-mini-3.8b").reduced(),
                              attn_impl="flash", dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = SyntheticCorpus(DataConfig(cfg.vocab_size, 16, 2)).batch(0)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(RuntimeError, match="no backward"):
        tts.make_loss_fn(cfg)(model, batch)
    # the forward alone runs on the flash path (its plain twin here)
    assert model.prefill(batch).shape == (2, 16, cfg.vocab_size)
    with torch.no_grad():
        logits, _ = model.train_logits(batch)
    assert not logits.requires_grad


def test_serving_builds_no_graph():
    cfg = get("qwen3-8b").reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(p.requires_grad for p in model.parameters())
    batch = SyntheticCorpus(DataConfig(cfg.vocab_size, 8, 2)).batch(0)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert not model.prefill(batch).requires_grad
    cache = model.init_cache(2, 16)
    step = {"tokens": batch["tokens"][:, :1],
            "positions": batch["positions"][:, :1]}
    logits, _ = model.decode_step(cache, step)
    assert not logits.requires_grad


@pytest.mark.parametrize("entry", ["launch_train", "train_lm", "serve_lm"])
def test_launcher_and_examples_run_on_the_cpu(entry, tmp_path, capsys):
    from repro_torch.examples import serve_lm, train_lm
    from repro_torch.launch import train as launch_train
    ck = str(tmp_path / "ck")
    if entry == "launch_train":
        assert launch_train.main(["--reduced", "--steps", "4", "--seq-len",
                                  "32", "--global-batch", "4", "--ckpt-dir",
                                  ck, "--device", "cpu"]) == 0
        assert "final loss" in capsys.readouterr().out
        assert os.listdir(ck)
    elif entry == "train_lm":
        out = train_lm.main(["--small", "--steps", "6", "--ckpt", ck,
                             "--device", "cpu"])
        assert len(out["history"]) == 6
    else:
        out = serve_lm.main(["--steps", "4", "--ckpt", ck, "--device",
                             "cpu"])
        assert all(r.done for r in out["requests"])
        assert out["pool"]["spills"] > 0


def test_training_needs_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the trainer runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(get("qwen3-8b").reduced(),
                TrainConfig(checkpoint_dir=str(tmp_path)))
