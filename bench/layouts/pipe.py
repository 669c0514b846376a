"""The pipelined trainer on one card: ``Trainer.run`` with ``pipe=S`` and no
mesh, so every stage runs in this process through ``LocalPipe``, with the
mix's schedule, microbatches, stash policy and overlapped per-stage sync."""
from bench import harness, weights


def processes(mix: dict) -> int:
    return 1


def build(run, model, m: dict, mix: dict):
    p = mix["pipeline"]
    return harness.make_trainer(
        model, m, mix, run.seed, run.device, run.use_kernels, pipe=p["stages"],
        pipeline={"schedule": p["schedule"], "num_microbatches": p["microbatches"],
                  "stash_policy": p["stash_policy"], "overlap_sync": p["overlap_sync"],
                  "chunk_bytes": p["chunk_bytes"]})


def units(trainer, m: dict, which: str) -> dict:
    st = trainer.state
    if which == "params":
        return weights.units_of_stage_stacked(m, st["stage_params"], st["shared_params"])
    return weights.units_of_stage_stacked(m, st[which]["stage"], st[which]["shared"])
