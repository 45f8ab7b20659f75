"""The controls that a cell's comparison has to fail, and the script that
reads them on the card.

* training: the plain reference put in the program's place and computed
  a precision below the configuration's bfloat16: every tensor that the
  program holds in bfloat16 rounded to fp8 instead (e4m3, one scale a
  tensor): the weights, activations and residual stream as the forward
  makes them (the backward passing the gradient straight through) and
  the weights' gradients as the optimizer gets them; read against the
  reference by the same numbers as the program;
* design-space sweeps: the program with its own approximate path on,
  its traces cut to a prefix of ``max_events`` events and the counters
  scaled up (``Sweep(max_events=...)``), read against the plain walk.

On the card, from the root of a checkout::

    python3 -m portbench.controls --workload <name> --seeds 1 2 3

prints one line of readings per seed.  For a training cell ``--read``
picks what is read instead of the control: ``program``, the program's
sound readings (beside them, under ``f32_weights``, the same against a
reference that computes with its float32 masters, not rounded to
bfloat16); ``half_batch`` or ``unwritten``, the program with that fault
planted (:func:`halved`, :func:`unwritten`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

FP8_MAX = 448.0                 # the largest finite float8_e4m3fn
TRUNCATE_EVENTS = 200_000


def fp8(x):
    """``x`` rounded through e4m3 at one scale for the whole tensor; the
    gradient passes straight through."""
    import torch
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    y = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (y - x.detach())


def _documents(spec: dict):
    from portbench import traffic
    config = spec["config"]
    return traffic.Documents(spec["traffic"], config["vocab_size"],
                             config["eos_token_id"])


def train_readings(spec: dict, seed: int, device) -> dict:
    """The fp8 control's readings against the reference."""
    from portbench.drivers import train
    config, docs = spec["config"], _documents(spec)
    ref = train.reference(config, seed, docs, device)
    ctl = train.reference(config, seed, docs, device, q=fp8)
    return train.readings(ctl, ref)


def halved(make_train_step):
    """The fault "half of the batch left out": ``make_train_step``
    wrapped so that each step takes the first half of the batch's rows,
    the loss their mean."""
    def make(cfg, opt_cfg, microbatches=1):
        step = make_train_step(cfg, opt_cfg, microbatches)

        def half(model, opt, err, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(model, opt, err,
                        {k: v[:rows] for k, v in batch.items()})
        return half
    return make


class _Unwritten:
    """A parameter whose write goes nowhere."""

    def copy_(self, _):
        return self


def unwritten(apply_updates):
    """The fault "parameters left unwritten": AdamW's step wrapped so
    that it updates the masters and moments but never writes the new
    values into the parameters the model computes with."""
    def updates(cfg, state, params, grads, err=None):
        _, state, err, stats = apply_updates(
            cfg, state, {k: _Unwritten() for k in params}, grads, err)
        return params, state, err, stats
    return updates


def fault_readings(spec: dict, seed: int, device, fault: str) -> dict:
    """The program with ``fault`` planted (``half_batch`` or
    ``unwritten``), read as a run reads the program."""
    from repro_torch.optim import adamw
    from repro_torch.train import train_step
    from portbench.drivers import train
    module, attr, wrap = {
        "half_batch": (train_step, "make_train_step", halved),
        "unwritten": (adamw, "apply_updates", unwritten)}[fault]
    real = getattr(module, attr)
    setattr(module, attr, wrap(real))
    try:
        out = train.run_cell(spec, seed, 0.0, False, time.perf_counter(),
                             device=device)
    finally:
        setattr(module, attr, real)
    return out["readings"]


def program_readings(spec: dict, seed: int, device) -> dict:
    """The program's readings as a run reads them and, under
    ``f32_weights``, against a reference that computes with its float32
    masters: what rounding the weights to bfloat16 accounts for."""
    from portbench.drivers import train
    from portbench.reference import dense_lm
    out = train.run_cell(spec, seed, 0.0, False, time.perf_counter(),
                         device=device)
    f32 = train.reference(spec["config"], seed, _documents(spec), device,
                          held=dense_lm.held_as("float32"))
    return dict(out["readings"],
                f32_weights=train.readings(out["program"], f32))


def sim_readings(spec: dict, seed: int, device, seconds: float) -> dict:
    """The truncated-prefix control run as a cell's window, compared as
    the cell compares the program."""
    from portbench.drivers import sim
    spec = dict(spec, config=dict(spec["config"],
                                  max_events=TRUNCATE_EVENTS))
    out = sim.run_cell(spec, seed, seconds, False, time.perf_counter(),
                       device=device)
    return {c["name"]: c["value"] for c in out["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--read", default="control",
                    choices=("control", "program", "half_batch", "unwritten"),
                    help="for a training cell: what to read")
    args = ap.parse_args(argv)
    from portbench import harness
    harness.use_checkout_caches()
    spec = harness.cell_spec(args.workload)
    harness.require_cards(int(spec["cell"]["chips"]))
    for seed in args.seeds:
        t = time.perf_counter()
        if spec["config"]["kind"] != "train":
            r = sim_readings(spec, seed, "cuda", args.seconds)
        elif args.read == "control":
            r = train_readings(spec, seed, "cuda")
        elif args.read == "program":
            r = program_readings(spec, seed, "cuda")
        else:
            r = fault_readings(spec, seed, "cuda", args.read)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              seconds=time.perf_counter() - t,
                              readings=r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
