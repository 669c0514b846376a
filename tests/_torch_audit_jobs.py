"""Subprocess jobs of the audit tests (``tests/test_torch_analysis.py``).

A fake default process group is process-global, and the reference's
pipelined trace needs several fake XLA devices, so each side runs in a
process of its own: ``python tests/_torch_audit_jobs.py <job> ...`` prints
one JSON object on its last line, ``{job: base64 of a pickle}``.

  port_units    rank logs of small programs in fake worlds (the unit cases)
  port_overlap  the audit's dense steps rank by rank: the overlapped step
                at (pipe 2, data 2), entropy on and off, the flat step on
                and off, and three seeded mutations (a dropped factor
                psum, a rank that skips a chunk, a host read in the step)
  ref_overlap   the reference's traced steps on Auto-axis meshes: the
                overlapped step's switch counts and declared budgets, and
                both entropy gates' psum counts
"""
from __future__ import annotations

import base64
import json
import os
import pickle
import sys


def _record(world: int, rank: int, prog):
    """``prog(groups)`` as ``rank`` of a fake (pipe 2, data 2)-shaped world
    under a fresh log; groups = {"data": ..., "pipe": ...} of this rank."""
    import torch.distributed as dist

    from repro_torch.analysis import CollectiveLog
    from repro_torch.launch.dryrun import fake_world

    with fake_world(world, rank=rank):
        pairs = {"data": [(0, 1), (2, 3)], "pipe": [(0, 2), (1, 3)]}
        groups = {}
        for axis, ranks in pairs.items():
            for rs in ranks:
                g = dist.new_group(list(rs))
                if rank in rs:
                    groups[axis] = g
        log = CollectiveLog()
        with log:
            prog(rank, groups)
        return log.freeze()


def port_units() -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.analysis import launch_label
    from repro_torch.dist.collectives import make_dp_pmean

    x = torch.ones(4)
    red = lambda g: dist.all_reduce(x.clone(), group=g)

    def signature(rank, g):
        y = make_dp_pmean(g["data"])(x)
        with launch_label(5, 0):
            for _ in range(3):
                dist.all_reduce(y, op=dist.ReduceOp.MAX, group=g["data"])
        make_dp_pmean(g["data"])(y)

    def lookalike(rank, g):
        all_reduce_lookalike = x.clone()
        make_dp_pmean(g["data"])(all_reduce_lookalike)

    def identical(rank, g):           # two equal "branches", by rank
        if rank % 2:
            make_dp_pmean(g["data"])(x * 2.0)
        else:
            make_dp_pmean(g["data"])(x + 1.0)

    def divergent(rank, g):           # a rank-dependent predicate
        if rank != 1:
            make_dp_pmean(g["data"])(x)

    def by_stage(rank, g):            # stages differ, each data group agrees
        for _ in range(1 + rank // 2):
            make_dp_pmean(g["data"])(x)

    def over_pipe(rank, g):           # stages differ on a pipe group
        if rank == 0:
            red(g["pipe"])

    def reduced(rank, g):             # a predicate equal over the group
        total = float(sum(range(4)))  # every data rank's summed value
        if total > 0:
            make_dp_pmean(g["data"])(x)

    def in_launch(rank, g):           # a divergence inside a launch
        for i in range(2):
            with launch_label(5, rank // 2):
                if not (rank == 1 and i == 1):
                    make_dp_pmean(g["data"])(x)

    def budgets(rank, g):             # launches of 1 and 2 all-reduces
        with launch_label(4, 0):
            red(g["data"])
        with launch_label(4, 1):
            red(g["data"])
            red(g["data"])

    def p2p(rank, g):                 # a send whose receive is longer
        if rank == 0:
            dist.send(torch.ones(4), 2, group=g["pipe"])
        if rank == 2:
            dist.recv(torch.ones(5), 0, group=g["pipe"])

    progs = {"signature": signature, "lookalike": lookalike,
             "identical": identical, "divergent": divergent,
             "by_stage": by_stage, "over_pipe": over_pipe,
             "reduced": reduced, "in_launch": in_launch,
             "budgets": budgets, "p2p": p2p}
    return {name: {r: _record(4, r, prog) for r in range(4)}
            for name, prog in progs.items()}


def port_overlap() -> dict:
    import torch

    from repro_torch.core import bucketing
    from repro_torch.core.sync_executor import SyncExecutor
    from repro_torch.launch import audit
    from repro_torch.train import step as step_mod

    torch.set_num_threads(2)
    dense = audit.FAMILY_CFGS["dense"]
    flat = audit.dataclasses.replace(dense, num_stages=1)

    def pipelined(rank, entropy=True):
        return audit.rank_job(dict(kind="pipelined", cfg=dense, rank=rank,
                                   entropy=entropy, overlap=True,
                                   device="cpu"))

    def flat_job(rank, entropy=True):
        return audit.rank_job(dict(kind="flat", cfg=flat, rank=rank,
                                   entropy=entropy, device="cpu"))

    out = {"overlap": {}, "flat": {}}
    for r in range(4):
        out["overlap"][r], extra = pipelined(r)
    out["oplan"], out["splans"] = extra["oplan"], extra["splans"]
    out["overlap_off0"] = pipelined(0, entropy=False)[0]
    out["flat"] = {r: flat_job(r)[0] for r in range(2)}
    out["flat_off0"] = flat_job(0, entropy=False)[0]

    # SEEDED MUTATION 1: drop the second factor psum of every group chunk
    # (no deadlock, the DP peers still agree, but the factors go unsynced)
    real = bucketing.sync_chunk_grads

    def dropping_chunks(grads_by_path, state, chunk, psum_mean, **kw):
        if chunk.kind == "group":
            seen = []

            def dropping(x):
                seen.append(x)
                return x if len(seen) >= 2 else psum_mean(x)
            return real(grads_by_path, state, chunk, dropping, **kw)
        return real(grads_by_path, state, chunk, psum_mean, **kw)

    bucketing.sync_chunk_grads = dropping_chunks
    try:
        out["dropped"] = {r: pipelined(r)[0] for r in range(4)}
    finally:
        bucketing.sync_chunk_grads = real

    # SEEDED MUTATION 2: rank 1 (stage 0's second data rank) runs the
    # first chunk of a launch without its collectives; on a real group
    # its peer would block in them
    run_chunks = SyncExecutor.run_chunks

    def skipping(self, d, ids, grads_by_path, comp_state, psum_mean):
        ids = tuple(ids)
        if not ids:
            return run_chunks(self, d, ids, grads_by_path, comp_state,
                              psum_mean)
        first, comp = run_chunks(self, d, ids[:1], grads_by_path,
                                 comp_state, lambda x: x)
        rest, comp = run_chunks(self, d, ids[1:], grads_by_path, comp,
                                psum_mean)
        return {**first, **rest}, comp

    out["skipping"] = {}
    for r in range(4):
        if r == 1:
            SyncExecutor.run_chunks = skipping
        try:
            out["skipping"][r] = pipelined(r)[0]
        finally:
            SyncExecutor.run_chunks = run_chunks

    # SEEDED MUTATION 3: a host read of the entropy inside the flat step
    entropy = step_mod.grads_entropy

    def reading(*a, **kw):
        h = entropy(*a, **kw)
        h.item()
        return h

    step_mod.grads_entropy = reading
    try:
        out["item"] = flat_job(0)[0]
    finally:
        step_mod.grads_entropy = entropy
    return out


def ref_overlap() -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses

    import jax
    import numpy as np
    from jax.sharding import AxisType, Mesh

    from repro import analysis
    from repro.launch.audit import FAMILY_CFGS, _trace_flat, _trace_pipelined
    from repro.pipeline.schedule import overlap_branch_psums

    devs = np.array(jax.devices()[:4])
    mesh_p = Mesh(devs.reshape(2, 2, 1), ("pipe", "data", "model"),
                  axis_types=(AxisType.Auto,) * 3)
    mesh_f = Mesh(devs[:2].reshape(2, 1), ("data", "model"),
                  axis_types=(AxisType.Auto,) * 2)
    cfg = FAMILY_CFGS["dense"]
    on, oplan, splans = _trace_pipelined(cfg, mesh_p, overlap=True)
    off, _, _ = _trace_pipelined(cfg, mesh_p, overlap=True,
                                 measure_entropy=False)
    flat_cfg = dataclasses.replace(cfg, num_stages=1)
    f_on = _trace_flat(flat_cfg, mesh_f, measure_entropy=True)
    f_off = _trace_flat(flat_cfg, mesh_f, measure_entropy=False)
    count = lambda t: analysis.count_collectives(t, "psum")
    return {
        "switches": [c for _, c in analysis.switch_collective_counts(on)],
        "declared": overlap_branch_psums(oplan, splans),
        "parity": [str(v) for v in analysis.check_collective_parity(on)],
        "pipelined_psums": (count(on), count(off)),
        "flat_psums": (count(f_on), count(f_off)),
    }


if __name__ == "__main__":
    jobs = {"port_units": port_units, "port_overlap": port_overlap,
            "ref_overlap": ref_overlap}
    out = {name: base64.b64encode(pickle.dumps(jobs[name]())).decode()
           for name in sys.argv[1:]}
    print(json.dumps(out))
