"""Subprocess jobs of the dry-run tests (``tests/test_torch_dryrun.py``,
``tests/test_torch_op_cost.py``).

A fake default process group is process-global, and the reference's
production mesh needs 512 fake XLA devices, so each side runs in a
process of its own: ``python tests/_torch_dryrun_jobs.py <job> ...``
prints one JSON object on its last line.

  port_collectives  op_cost over a fake world of 8 ranks (pods of 4)
  port_mesh         make_production_mesh's shapes and axis names
  port_flops        the dry run's train record of each family, reduced
  port_allreduce4   the dry run's train record at a fake data-4 world
  port_flops_2x2    the dry run's train FLOPs at a fake (data 2, model 2)
  ref_mesh          the reference's make_production_mesh (512 devices)
  ref_flops         the reference's _lower_train of each family, reduced
  ref_flops_2x2     the reference's at an Auto-axis 2 x 2 mesh
"""
from __future__ import annotations

import json
import os
import sys

#: one reduced config per family, and the tiny train shape both packages
#: count them at (a 1 x 1 mesh)
FAMILY_ARCHS = {"dense": "qwen2-0.5b", "moe": "qwen3-moe-235b-a22b",
                "vlm": "phi-3-vision-4.2b", "xlstm": "xlstm-125m",
                "zamba": "zamba2-7b", "whisper": "whisper-base"}
TINY = {"seq_len": 32, "global_batch": 2, "kind": "train"}
#: the configs counted at (data 2, model 2), 2 rows a data rank: every
#: family whose heads (and KV heads) split over model 2, FSDP + TP too
SPLIT_ARCHS = {"dense": "qwen2.5-3b", "dense_auto": "llama3-405b",
               "vlm": "phi-3-vision-4.2b", "xlstm": "xlstm-125m",
               "whisper": "whisper-base"}
TINY_2X2 = dict(TINY, global_batch=4)


def tiny_config(get_config, arch: str):
    """The reduced config at attention blocks of 16 (and Whisper's 32
    frames), which divide every attention length: the reference pads a
    query block to its full ``block_q``, which at these lengths would
    count 16 to 32 times the work of the rows that exist."""
    import dataclasses
    extra = {"audio_frames": 32} if arch == "whisper-base" else {}
    return dataclasses.replace(get_config(arch, "reduced"), block_q=16,
                               **extra)


RANK = 4
MESHES = {"single": {}, "multi": {"multi_pod": True},
          "pipe2": {"pipe": 2}, "pipe4": {"pipe": 4}}


def port_collectives() -> dict:
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.op_cost import OpCounter

    out = {}
    with fake_world(8):
        pod = dist.new_group([0, 1, 2, 3])
        across = dist.new_group([0, 4])
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "x"))
        with FakeTensorMode():
            t = torch.zeros((4, 4))
            cases = {
                "all_reduce_intra": lambda: dist.all_reduce(t, group=pod),
                "all_reduce_cross": lambda: dist.all_reduce(t, group=across),
                "all_gather": lambda: dist.all_gather(
                    [torch.empty_like(t) for _ in range(4)], t, group=pod),
                "redistribute": lambda: DTensor.from_local(
                    torch.zeros((2, 4)), mesh["x"], [Shard(0)],
                    run_check=False).redistribute(mesh["x"], [Replicate()]),
                "reduce_scatter": lambda: DTensor.from_local(
                    torch.zeros((8, 4)), mesh["x"], [Partial()],
                    run_check=False).redistribute(mesh["x"], [Shard(0)]),
                "dtensor_across_pods": lambda: DTensor.from_local(
                    torch.zeros((2, 4)), mesh["pod"], [Shard(0)],
                    run_check=False).redistribute(mesh["pod"], [Replicate()]),
            }
            for name, fn in cases.items():
                c = OpCounter(pod_size=4)
                with c:
                    fn()
                out[name] = c.result()
    return out


def port_mesh() -> dict:
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import dp_axes, make_production_mesh

    out = {}
    for name, kw in MESHES.items():
        with fake_world(512 if kw.get("multi_pod") else 256):
            m = make_production_mesh(device_type="cpu", **kw)
            out[name] = {"shape": list(m.shape),
                         "names": list(m.mesh_dim_names),
                         "dp_axes": list(dp_axes(m))}
    try:
        with fake_world(256):
            make_production_mesh(pipe=3, device_type="cpu")
        out["pipe3"] = "no error"
    except ValueError as e:
        out["pipe3"] = str(e)
    return out


def port_flops() -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, sharding_mode
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model

    out = {}
    for fam, arch in FAMILY_ARCHS.items():
        cfg = tiny_config(get_config, arch)
        mode = sharding_mode(arch)
        with dryrun.fake_world(1):
            mesh = init_device_mesh("cpu", (1, 1),
                                    mesh_dim_names=("data", "model"))
            rec = dryrun._lower_train(cfg, build_model(cfg), mesh, mode,
                                      TINY, "fixed", RANK)
        out[fam] = rec["flops_per_chip"]
    return out


def port_flops_2x2() -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, sharding_mode
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model

    out = {}
    for fam, arch in SPLIT_ARCHS.items():
        cfg = tiny_config(get_config, arch)
        with dryrun.fake_world(4):
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
            rec = dryrun._lower_train(cfg, build_model(cfg), mesh,
                                      sharding_mode(arch), TINY_2X2, "fixed",
                                      RANK)
        out[fam] = rec["flops_per_chip"]
    return out


def port_allreduce4() -> dict:
    spec = dict(TINY, global_batch=8)
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import lower_one
    rec = lower_one("qwen2-0.5b", "tiny", device="cpu",
                    mesh_shape={"data": 4, "model": 1},
                    cfg=get_config("qwen2-0.5b", "reduced"), spec=spec,
                    policy="fixed", rank=RANK)
    return {"collective_bytes": rec["collective_bytes_per_chip"],
            "compressed_leaves": rec["compressed_leaves"]}


def _ref_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as ref    # sets XLA_FLAGS for 512 devices
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return ref


def ref_mesh() -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    from repro.launch.mesh import dp_axes, make_production_mesh
    out = {}
    for name, kw in MESHES.items():
        m = make_production_mesh(**kw)
        out[name] = {"shape": list(m.devices.shape),
                     "names": list(m.axis_names), "dp_axes": list(dp_axes(m))}
    try:
        make_production_mesh(pipe=3)
        out["pipe3"] = "no error"
    except ValueError as e:
        out["pipe3"] = str(e)
    return out


def ref_flops() -> dict:
    import jax
    import numpy as np
    from jax.sharding import AxisType, Mesh

    ref = _ref_dryrun()
    from repro import configs
    from repro.dist.sharding import param_shardings
    from repro.models.model import build_model

    configs.INPUT_SHAPES["tiny"] = TINY
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    out = {}
    for fam, arch in FAMILY_ARCHS.items():
        cfg = tiny_config(configs.get_config, arch)
        mode = configs.sharding_mode(arch)
        model = build_model(cfg)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        pshard = param_shardings(shapes, mesh, fsdp=(mode == "auto"))
        rec = ref._lower_train(arch, cfg, model, mesh, mode, shapes, pshard,
                               "tiny", "fixed", RANK)
        out[fam] = rec["flops_per_chip"]
    return out


def ref_flops_2x2() -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import AxisType, Mesh

    ref = _ref_dryrun()
    from repro import configs
    from repro.dist.sharding import param_shardings
    from repro.models.model import build_model

    configs.INPUT_SHAPES["tiny_2x2"] = TINY_2X2
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    out = {}
    for fam, arch in SPLIT_ARCHS.items():
        cfg = tiny_config(configs.get_config, arch)
        mode = configs.sharding_mode(arch)
        model = build_model(cfg)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        pshard = param_shardings(shapes, mesh, fsdp=(mode == "auto"))
        rec = ref._lower_train(arch, cfg, model, mesh, mode, shapes, pshard,
                               "tiny_2x2", "fixed", RANK)
        out[fam] = rec["flops_per_chip"]
    return out


JOBS = {f.__name__: f for f in (port_collectives, port_mesh, port_flops,
                                port_allreduce4, port_flops_2x2, ref_mesh,
                                ref_flops, ref_flops_2x2)}


if __name__ == "__main__":
    result = {name: JOBS[name]() for name in sys.argv[1:]}
    print(json.dumps(result))
