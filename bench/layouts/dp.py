"""Data parallelism over cards: one process a card, the flat step on a
``data`` mesh of all of them (``launch.mesh.make_host_mesh(data=W)``, as
``launch/train.py --data-mesh W`` builds it), each process taking its
contiguous rows of the global batch; NCCL on the card, gloo on the CPU."""
from bench import harness, weights


def processes(mix: dict) -> int:
    return int(mix["replicas"])


def build(run, model, m: dict, mix: dict):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=run.world, device_type="cuda" if run.cuda else "cpu")
    return harness.make_trainer(model, m, mix, run.seed, run.device,
                                run.use_kernels, mesh=mesh)


def units(trainer, m: dict, which: str) -> dict:
    return weights.units_of_flat(m, trainer.state[which])
