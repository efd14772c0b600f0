"""Readings that the limits of ``correct`` are set from (never run by the
benchmark's own runs).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 [--seconds 2]

For each of ``--seeds`` it reads the numbers a run compares from the
program: a serve cell's answers of a short window at the cell's own load,
a train cell's first checked steps and its late steps from step
``late_from`` of its mix. For each of ``--control-seeds`` it reads them from the
control, the reference put in the program's place one precision below the
configuration's (a serve cell: float8 products under bfloat16 autocast; a
train cell: bfloat16 autocast), and from faults: a serve cell's half batch
(stale answers where a batch holds one crop) and altered maxvals planted in
the program (``core/faults.py``), a train cell's half batch in the
reference put in its place. One JSON line each, then the largest program
reading and the smallest control or fault reading of each number. Limits
live in ``limits/<cell>.json``; the readings they were set from are in
``PERF.md``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def serve_readings(r, kind: str) -> dict:
    """The numbers a serve run compares, read from ``kind``: the program
    (``program``; ``program_fp32``, a witness: the program in float32 with
    TF32 off), the program with a fault of ``core/faults.py`` planted, or
    the control."""
    import contextlib

    import torch

    from perfbench.core import faults, program, serve

    cfg = r.cell.port_config(r.overrides)
    kernel = int(cfg.PIPELINE.kernel[0])
    D = int(r.cell.mix["distinct"])
    images, centers, scales = serve.make_inputs(r, cfg.DATASET.image_size)
    answers = []
    if kind != "control":
        if kind == "program_fp32":
            r.cell.config = dict(r.cell.config, serve=dict(
                r.cell.config["serve"], dtype="float32"))
            torch.backends.cudnn.allow_tf32 = False
        with (faults.planted(kind) if kind in faults.SERVE
              else contextlib.nullcontext()):
            served = program.predictor(r)

            def call(j):
                return served(images[j], centers[j], scales[j])

            for i in range(int(r.cell.mix["warmup"])):
                call(i % D)
            serve.closed_loop(call, D, r.seconds, answers)
        del served, call
    else:
        control = serve.reference_answers(r, images, centers, scales, kernel,
                                          control=True)
        answers = [(j, c["preds"].float().cpu(), c["maxvals"].float().cpu())
                   for j, c in enumerate(control)]
        del control
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    refs = serve.reference_answers(r, images, centers, scales, kernel)
    every = {n: {"limit": float("inf")} for n in SERVE_NUMBERS}
    numbers, attempted, _ = serve.judge(answers, refs, every, r.device)
    return dict(numbers, answers=attempted,
                well=int(sum(int(ref["well"].sum()) for ref in refs)))


SERVE_NUMBERS = ("maxval_mean_gap", "pred_p75_px")


_LATE = {}   # seed -> the program's late steps


def train_readings(r, kind: str) -> dict:
    """The numbers a train run compares, read from ``kind``: the program
    (``program``; ``program_notf32``, a witness: the program with TF32
    off), the control (``bf16``) or the fault ``half_batch``, each put in
    the program's place. The late steps start from the program's state
    before step ``late_from`` (read once a seed, shared by the control and
    the fault)."""
    import torch

    from perfbench.core import program, train

    cfg = r.cell.port_config(r.overrides)
    mix = r.cell.mix
    n, n_late = int(mix["checked_steps"]), int(mix["late_steps"])
    data = train.make_batches(r, cfg)
    is_program = kind in ("program", "program_notf32")
    late = None if is_program else _LATE.get(r.seed)
    if late is None:
        torch.backends.cudnn.allow_tf32 = kind != "program_notf32"
        weights = program.seeded_weights(r)
        tr, state = program.trainer(r, weights)

        def step(k):
            gen = torch.Generator(r.device).manual_seed(train.step_seed(r, k))
            return tr.train_step(state, train.batch(data, k), gen)

        first = train.first_steps(r, step, state.model, state.optimizer,
                                  weights, n)
        steps = train.LateSteps(state.model, state.optimizer,
                                max(int(mix["late_from"]), n), n_late)
        k = n
        while not steps.done:
            steps.step(step, k)
            k += 1
        late = steps.result()
        del tr, state, step, steps
        if kind != "program_notf32":
            _LATE[r.seed] = late
    if not is_program:
        first = train.reference_steps(r, data, n, control=kind)
        late = dict(late, **train.reference_late(r, data, late["snapshot"],
                                                 n_late, control=kind))
    first = {"loss": [float(v) for v in first["loss"]],
             "grad": {k: float(v) for k, v in first["grad"].items()},
             "change": {k: float(v) for k, v in first["change"].items()}}
    torch.backends.cudnn.allow_tf32 = True
    ref = train.reference_steps(r, data, n)
    numbers, still = train.judge(first, ref)
    numbers.update(train.judge_late(late, train.reference_late(
        r, data, late["snapshot"], n_late)))
    return dict(numbers, still_leaves=len(still),
                late_k=late["snapshot"]["k"], **leaf_detail(first, ref, still))


def leaf_detail(prog: dict, ref: dict, still) -> dict:
    """The three leaves with the widest gap of each number, with their
    norms and sizes, the median leaf's gap and the losses."""
    import statistics

    out = {"loss": prog["loss"], "loss_ref": [float(v) for v in ref["loss"]]}
    for key in ("grad", "change"):
        r_ = {k: float(v) for k, v in ref[key].items()}
        names = [k for k in r_ if key == "grad" or k not in still]
        med = statistics.median(r_[k] for k in names)
        gaps = {k: abs(prog[key][k] - r_[k]) / max(r_[k], med) for k in names}
        top = sorted(gaps, key=gaps.get, reverse=True)[:3]
        out[f"{key}_worst"] = [[k, gaps[k], prog[key][k], r_[k]] for k in top]
        if key == "change":
            out["change_median_gap"] = statistics.median(gaps.values())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--witness", action="store_true",
                   help="also read the program with TF32 off (train) or "
                        "in float32 (serve)")
    args = p.parse_args(argv)
    import torch

    from perfbench.core import spec
    from perfbench.core.run_context import Run

    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available():
        print("calibration reads the chip; no CUDA device", file=sys.stderr)
        return 2
    B = int(cell.mix["batch"])
    kinds = {"serve": ["control", "half_batch" if B > 1 else "stale",
                       "altered_maxval"],
             "train": ["bf16", "half_batch"]}
    p_kinds = {"serve": ["program"], "train": ["program"]}
    if args.witness:
        p_kinds = {"serve": ["program", "program_fp32"],
                   "train": ["program", "program_notf32"]}
    readings = serve_readings if cell.mix["kind"] == "serve" else train_readings
    rows = []
    plan = ([(s, k) for s in args.seeds for k in p_kinds[cell.mix["kind"]]]
            + [(s, k) for s in args.control_seeds for k in kinds[cell.mix["kind"]]])
    for seed, kind in plan:
        r = Run(cell=spec.Cell(args.workload), seed=seed, seconds=args.seconds, trace=False,
                device=torch.device("cuda", 0), t0=T0)
        t = time.perf_counter()
        row = dict(workload=cell.name, seed=seed, kind=kind,
                   **readings(r, kind), s=time.perf_counter() - t)
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = [n for n in rows[0] if isinstance(rows[0][n], float)
             and n not in ("s",)] if rows else []
    summary = {"workload": cell.name}
    for kind in sorted({k for _, k in plan}):
        got = [row for row in rows if row["kind"] == kind]
        pick = max if kind.startswith("program") else min
        summary[kind] = {n: pick(row[n] for row in got) for n in names}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
