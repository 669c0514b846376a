"""Readings that set a cell's limits: the program's numbers on many seeds,
the control's, and those of the faults the cell can have.

    python3 bench/control.py --workload gpt2-2.5b.flat.r64 \\
        --seeds 11,12,13 --control-seeds 21,22,23 --fault-seeds 31,32,33 \\
        --out readings.json

For each seed of ``--seeds`` the cell's trainer is built, its first three
steps run as in a benchmark run, and its numbers are compared with the
reference's (no measured window: training's readings need none). For each
``--control-seeds`` seed the reference computed in fp8
(``reference/control.py``) takes the program's place. For each
``--fault-seeds`` seed every fault of ``--faults`` is planted under the
program. Run on the card; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

import torch  # noqa: E402

from bench import catalog, faults, harness, synth, weights  # noqa: E402
from bench.reference import control as ref_control  # noqa: E402
from bench.reference import train as ref_train  # noqa: E402


def unit_readings(prog: dict, ref: dict) -> dict:
    """Every unit's gap, of the first gradient and of the change."""
    return {"grad_norm": harness.unit_gaps(prog, ref, "grad_norm"),
            "change_norm": harness.unit_gaps(prog, ref, "change_norm",
                                             harness.moved_units(ref))}


def brief(r: dict) -> dict:
    return {k: v for k, v in r.items() if isinstance(v, float)}


def program_reading(c, seed: int, dev, fault=None, use_kernels: bool = True) -> dict:
    run = harness.Run(c, seed, dev, use_kernels=use_kernels, fault=fault)
    run.setup()
    prog = run.first_steps()
    run.release()
    ref = run.reference(prog)
    out = harness.readings(prog, ref)
    out["units"] = unit_readings(prog, ref)
    out["loss"], out["ref_loss"] = prog["loss"], ref["loss"]
    return out


def control_reading(c, seed: int, dev) -> dict:
    start = weights.make(c.model, seed, dev)
    u0 = {k: v.float() for k, v in weights.units_of_flat(c.model, start).items()}
    del start
    pool = synth.pool(c.model["vocab_size"], c.mix, seed, dev)[:harness.CHECK_STEPS]
    ref = ref_train.run(c.model, c.mix, u0, pool, seed)
    low = ref_train.run(c.model, c.mix, u0, pool, seed, mm=ref_control.fp8_matmul)
    out = harness.readings(low, ref)
    out["units"] = unit_readings(low, ref)
    return out


def reference_fault_reading(c, seed: int, dev, name: str) -> dict:
    """A fault planted in the reference put in the program's place, read
    as the program's rank 0 would report it: ``no_exchange``, each replica
    keeping its own gradient (replica 0's rows alone); ``half_batch``,
    each replica using the first half of its rows."""
    start = weights.make(c.model, seed, dev)
    u0 = {k: v.float() for k, v in weights.units_of_flat(c.model, start).items()}
    del start
    pool = synth.pool(c.model["vocab_size"], c.mix, seed, dev)[:harness.CHECK_STEPS]
    R, per = c.mix.get("replicas", 1), c.mix["batch"]
    ref = ref_train.run(c.model, c.mix, u0, pool, seed)
    if name == "no_exchange":
        rows, mix = slice(0, per), dict(c.mix, replicas=1)
        bad = [{k: v[rows] for k, v in b.items()} for b in pool]
    else:
        keep = torch.cat([torch.arange(r * per, r * per + per // 2) for r in range(R)])
        mix, bad = c.mix, [{k: v[keep.to(v.device)] for k, v in b.items()} for b in pool]
    low = ref_train.run(c.model, mix, u0, bad, seed)
    out = harness.readings(low, ref)
    out["units"] = unit_readings(low, ref)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="half_batch")
    ap.add_argument("--faults-in-reference", action="store_true",
                    help="plant the faults in the reference put in the program's "
                         "place (a cell of several cards read on one)")
    ap.add_argument("--plain", action="store_true",
                    help="a witness: the program without its kernels (torch QR) "
                         "against the reference orthonormalising by QR")
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    c = catalog.cell(a.workload)
    if a.plain:
        c.mix = dict(c.mix, orthonormalisation={"method": "qr"})
    dev = torch.device("cuda", torch.cuda.current_device())
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    got = {"workload": a.workload, "device": torch.cuda.get_device_name(),
           "program": {}, "control": {}, "faults": {}}

    def save():
        gc.collect()
        torch.cuda.empty_cache()
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(got, f, indent=1)

    for s in seeds(a.control_seeds):
        t = time.time()
        got["control"][s] = control_reading(c, s, dev)
        harness.say(f"control seed {s}: {brief(got['control'][s])} ({time.time() - t:.1f} s)")
        save()
    for s in seeds(a.fault_seeds):
        for name in a.faults.split(","):
            t = time.time()
            got["faults"].setdefault(name, {})[s] = (
                reference_fault_reading(c, s, dev, name) if a.faults_in_reference
                else program_reading(c, s, dev, faults.FAULTS[name]))
            harness.say(f"fault {name} seed {s}: {brief(got['faults'][name][s])} "
                        f"({time.time() - t:.1f} s)")
            save()
    for s in seeds(a.seeds):
        t = time.time()
        got["program"][s] = program_reading(c, s, dev, use_kernels=not a.plain)
        harness.say(f"program seed {s}: {brief(got['program'][s])} ({time.time() - t:.1f} s)")
        save()


if __name__ == "__main__":
    main()
