"""CPU tests that a cell's comparison catches what it has to: each run
is driven through the harness's driver at a small size, with the card
check skipped and the timed path broken underneath, and ``correct``
must come out false.  The controls (the cell's lower-precision or
approximate path) must fail too; a sound run must pass."""

import json
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from portbench import controls, harness  # noqa: E402
from portbench.drivers import sim, train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 1234


def _correct(out) -> bool:
    return all(c["ok"] for c in out["checks"])


# ---------------------------------------------------------------- sweeps --

def _sim_spec(**config):
    """The paper's sweep (``configs/rvv-paper.json``, traffic ``dse``) at
    a small size."""
    pkg = ROOT / "portbench"
    cfg = json.loads((pkg / "configs" / "rvv-paper.json").read_text())
    cfg = dict(cfg, kernel_params="reduced",
               programs=["pathfinder", "gemv", "dropout"])
    cfg["design_space"] = dict(cfg["design_space"], capacity=[3, 8, 32],
                               policy=[0, 3], mem_latency=[1, 5])
    cfg.update(config)
    return dict(config=cfg, cell=dict(name="sim.rvv-paper.dse"),
                traffic=json.loads((pkg / "traffic" / "dse.json"
                                    ).read_text()))


def _sim_run(spec=None):
    harness.use_checkout_caches()
    return sim.run_cell(spec or _sim_spec(), SEED, 0.5, False,
                        time.perf_counter(), device="cpu", workers=1)


def test_sim_sound_run_is_correct():
    out = _sim_run()
    assert _correct(out)
    assert out["attempted"] >= 1


def _wrap_engine(monkeypatch, change):
    from repro_torch.kernels import engine_scan as k1
    real = k1.engine_scan

    def broken(*args, **kw):
        return change(real, args, kw)
    monkeypatch.setattr(k1, "engine_scan", broken)


def test_sim_answer_altered_is_caught(monkeypatch):
    def altered(real, args, kw):
        ctr, a, b = real(*args, **kw)
        ctr = ctr.clone()
        ctr[0, 0, 0, 0] += 1               # one point's cycles, once made
        return ctr, a, b
    _wrap_engine(monkeypatch, altered)
    assert not _correct(_sim_run())


def test_sim_state_unchanged_is_caught(monkeypatch):
    def unchanged(real, args, kw):
        return tuple(torch.zeros_like(t) for t in real(*args, **kw))
    _wrap_engine(monkeypatch, unchanged)
    assert not _correct(_sim_run())


def test_sim_half_the_rows_left_out_is_caught(monkeypatch):
    def half(real, args, kw):
        kw = dict(kw, lengths=kw["lengths"] // 2)
        return real(*args, **kw)
    _wrap_engine(monkeypatch, half)
    assert not _correct(_sim_run())


def test_sim_control_truncated_prefix_fails():
    out = _sim_run(_sim_spec(max_events=300))
    checks = {c["name"]: c for c in out["checks"]}
    assert checks["counters_unequal"]["value"] > 0
    assert not _correct(out)


# -------------------------------------------------------------- training --

TINY = dict(name="tiny", kind="train", hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=4,
            num_hidden_layers=2, vocab_size=256, rms_norm_eps=1e-5,
            rope_theta=10000.0, sliding_window=24,
            tie_word_embeddings=False, torch_dtype="bfloat16",
            eos_token_id=255)


def _train_spec():
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "phi3-mini-3.8b.json").read_text())
    mix = json.loads((ROOT / "portbench" / "traffic" / "4x1024.json"
                      ).read_text())
    mix = dict(mix, batch=4, seq_len=32,
               documents=dict(mix["documents"], median_tokens=20,
                              min_tokens=4, max_tokens=64))
    return dict(config=dict(TINY, optimizer=cfg["optimizer"]), traffic=mix,
                cell=dict(name="train.phi3-mini.4x1024"))


def _train_run():
    harness.use_checkout_caches()
    return train.run_cell(_train_spec(), SEED, 0.2, False,
                          time.perf_counter(), device="cpu")


def _readings(out):
    return {c["name"]: c["value"] for c in out["checks"]}


@pytest.fixture(scope="module")
def sound_train():
    return _readings(_train_run())


def test_train_state_unchanged_is_caught(monkeypatch, sound_train):
    from repro_torch.optim import adamw

    def unchanged(cfg, state, params, grads, err=None):
        return params, state, err, {"grad_norm": torch.zeros(()),
                                    "lr": torch.zeros(())}
    monkeypatch.setattr(adamw, "apply_updates", unchanged)
    out = _train_run()
    assert not _correct(out)
    assert _readings(out)["grad_norm_gap"] == pytest.approx(1.0)


def test_train_params_left_unwritten_are_caught(monkeypatch, sound_train):
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "apply_updates",
                        controls.unwritten(adamw.apply_updates))
    out = _train_run()
    assert not _correct(out)
    assert _readings(out)["param_gap"] == pytest.approx(1.0)


def test_train_half_the_batch_left_out_is_caught(monkeypatch, sound_train):
    from repro_torch.train import train_step
    monkeypatch.setattr(train_step, "make_train_step",
                        controls.halved(train_step.make_train_step))
    out = _train_run()
    assert not _correct(out)
    got = _readings(out)
    assert max(got[k] / max(sound_train[k], 1e-12) for k in got) > 10


def test_train_control_fp8_fails(sound_train):
    spec = _train_spec()
    r = controls.train_readings(spec, SEED, "cpu")
    failed = [k for k, lim in train.limits("train.phi3-mini.4x1024").items()
              if r[k] > lim]
    assert failed, r
    assert any(r[k] > 3 * sound_train[k] for k in failed)
