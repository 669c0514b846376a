"""The reference side of the outer-optimizer parity tests
(``tests/test_torch_outer.py``): the reference ``OuterOptimizer`` on an
Auto-axis ``("pod",)`` mesh (``jax.make_mesh`` builds Explicit axes under
jax 0.9, on which the reference's elastic code fails), run for a few rounds
on seeded per-pod deltas, with every collective payload recorded.

Each pod's payload is what that pod sends into the pod mean: the coded
value under a coded wire. A ``jax.debug.callback`` inside the ``shard_map``
region hands it to the host, keyed by (call index at trace time, pod).

Run in this process for one pod; for several, in a subprocess whose host
platform has 4 devices:

  XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
      python tests/_torch_outer_ref.py OUT.pkl 2 3
"""
import os
import pickle
import sys

import numpy as np

TINY = dict(name="el", family="dense", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512)
POLICIES = ("none", "fixed", "edgc")
WIRES = ("raw", "quant8", "quant4", "entropy")
ROUNDS = 3


def deltas(shapes: list[tuple], n_pods: int, rnd: int) -> list[list]:
    """Seeded per-pod outer deltas of one round, one list of leaves a pod:
    a shared drift plus each pod's own part, 1e-2 in scale at round 0 and
    a fifth of that each round after (the entropy falls by ln 5 a round:
    the edgc plan leaves its warm-up and the entropy wire narrows)."""
    out = []
    for pod in range(n_pods):
        leaves = []
        for i, shape in enumerate(shapes):
            rng = np.random.default_rng(1000 * rnd + 7 * i)
            common = rng.standard_normal(shape, dtype=np.float32)
            rng = np.random.default_rng(1000 * rnd + 7 * i + 100 * (pod + 1))
            own = rng.standard_normal(shape, dtype=np.float32)
            scale = 1e-2 * 0.2 ** rnd
            leaves.append((scale * (common + 0.5 * own)).astype(np.float32))
        out.append(leaves)
    return out


def ocfg_kwargs(policy: str, wire: str) -> dict:
    return dict(outer_k=5, policy=policy, fixed_rank=8, wire=wire, window=1,
                total_rounds=4)


def run(n_pods: int, cases=None) -> dict:
    import jax
    from jax.sharding import AxisType, Mesh

    import repro.optim.outer as ref_outer
    from repro.models.model import ModelConfig, build_model
    from repro.optim.outer import OuterConfig, OuterOptimizer

    state = {"on": False, "calls": {}, "trace_idx": 0}
    base_pmean = ref_outer.make_dp_pmean

    def recording_pmean(axes):
        mean = base_pmean(axes)

        def pmean(x):
            idx = state["trace_idx"]
            state["trace_idx"] += 1

            def keep(v, pod):
                if state["on"]:
                    state["calls"][(idx, int(pod))] = np.asarray(v)
            jax.debug.callback(keep, x, jax.lax.axis_index("pod"))
            return mean(x)
        return pmean

    ref_outer.make_dp_pmean = recording_pmean
    mesh = Mesh(np.array(jax.devices()[:n_pods]), ("pod",),
                axis_types=(AxisType.Auto,))
    model = build_model(ModelConfig(**TINY))
    params = jax.device_get(model.init(jax.random.PRNGKey(0)))
    treedef = jax.tree_util.tree_structure(params)
    shapes = [tuple(a.shape) for a in jax.tree_util.tree_leaves(params)]
    results = {"params": params, "cases": {}}
    for policy, wire in (cases or [(p, w) for p in POLICIES for w in WIRES]):
        opt = OuterOptimizer(params, OuterConfig(**ocfg_kwargs(policy, wire)),
                             mesh, TINY["num_layers"], seed=0)
        rows = [{"arrays": jax.device_get(opt.arrays)}]
        anchor = params
        for rnd in range(ROUNDS):
            per_pod = [jax.tree_util.tree_unflatten(treedef, ls)
                       for ls in deltas(shapes, n_pods, rnd)]
            # the sync step alone, its payloads recorded (round() runs the
            # same compiled step again, unrecorded)
            plan, codec = opt.plan, opt._codec
            state["calls"], state["trace_idx"] = {}, 0
            leaves_list = [jax.tree_util.tree_leaves(d) for d in per_pod]
            delta = jax.tree_util.tree_unflatten(treedef, [
                opt._pod_array([ls[i] for ls in leaves_list])
                for i in range(len(shapes))])
            state["on"] = True
            synced, _, h = opt._get_sync(plan)(delta, opt._comp)
            synced = jax.device_get(synced)
            jax.effects_barrier()
            state["on"] = False
            calls = state["calls"]
            n_calls = 1 + max(i for i, _ in calls) if calls else 0
            payloads = [np.stack([calls[(i, p)] for p in range(n_pods)])
                        for i in range(n_calls)]
            anchor, info = opt.round(anchor, per_pod)
            jax.effects_barrier()
            rows.append({"synced": synced, "entropy": float(h),
                         "anchor": anchor, "info": info,
                         "codec_bits": None if codec is None else codec.bits,
                         "payloads": payloads,
                         "arrays": jax.device_get(opt.arrays),
                         "state": opt.state_dict(),
                         "comm_savings": opt.comm_savings()})
        results["cases"][(policy, wire)] = rows
    ref_outer.make_dp_pmean = base_pmean
    return results


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out, counts = sys.argv[1], [int(n) for n in sys.argv[2:]]
    with open(out, "wb") as f:
        pickle.dump({n: run(n) for n in counts}, f)
    print("REF_OUTER_OK")
