"""The model's weights, made by the benchmark from the seed, and their units.

The tree is laid out as the port's dense family takes it (the ``init``
hook of its model): ``embed.tok``, ``pos_embed``, the final norm, and
``stages[s].blocks`` with every block leaf stacked over the stage's
layers. All leaves are views of one buffer drawn on the device in one
call, then scaled per leaf: normal(0, 1/sqrt(d_in)) for projections,
0.02 for the table, 0.01 for learned positions, ones for norm scales and
zeros for biases (the port's and its JAX reference's initialisers).

A *unit* is one layer's slice of a stacked leaf (``L3.attn.wq``) or one
shared leaf (``embed.tok``): the granularity at which the reference and the
program's outputs are compared, whatever layout stacked them.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: tuple          # keys in the port's tree, e.g. ("stages", 0, "blocks", "attn", "wq")
    shape: tuple[int, ...]
    init: str            # normal | ones | zeros
    scale: float = 1.0

    @property
    def keystr(self) -> str:
        return "".join(f"[{k!r}]" for k in self.path)

    @property
    def stacked(self) -> bool:
        return self.path[0] == "stages"


def stage_sizes(m: dict) -> list[int]:
    base, extra = divmod(m["num_layers"], max(1, m["num_stages"]))
    return [base + (1 if i < extra else 0) for i in range(max(1, m["num_stages"]))]


def head_dim(m: dict) -> int:
    return m["head_dim"] or m["d_model"] // m["num_heads"]


def gated(m: dict) -> bool:
    return m["act"] in ("silu", "gelu")


def leaves(m: dict) -> list[Leaf]:
    """Every leaf of the tree in the port's flatten order (dict keys
    sorted, lists in order)."""
    d, ff, V = m["d_model"], m["d_ff"], m["vocab_size"]
    hq, hkv = m["num_heads"] * head_dim(m), m["num_kv_heads"] * head_dim(m)
    ln = m["norm"] == "layernorm"
    normal = lambda shape: (shape, "normal", 1.0 / math.sqrt(shape[-2]))
    out: dict[tuple, tuple] = {("embed", "tok"): ((V, d), "normal", 0.02),
                               ("final_norm_scale",): ((d,), "ones", 1.0)}
    if ln:
        out[("final_norm_bias",)] = ((d,), "zeros", 1.0)
    if m["pos"] == "learned":
        out[("pos_embed",)] = ((m["max_position"], d), "normal", 0.01)
    if not m["tie_embeddings"]:
        out[("lm_head",)] = normal((d, V))
    for s, n in enumerate(stage_sizes(m)):
        blk = {("attn", "wq"): normal((n, d, hq)), ("attn", "wk"): normal((n, d, hkv)),
               ("attn", "wv"): normal((n, d, hkv)), ("attn", "wo"): normal((n, hq, d)),
               ("attn_norm_scale",): ((n, d), "ones", 1.0),
               ("mlp_norm_scale",): ((n, d), "ones", 1.0),
               ("mlp", "up"): normal((n, d, ff)), ("mlp", "down"): normal((n, ff, d))}
        if m["qkv_bias"]:
            for k, w in (("q_bias", hq), ("k_bias", hkv), ("v_bias", hkv)):
                blk[("attn", k)] = ((n, w), "zeros", 1.0)
        if gated(m):
            blk[("mlp", "gate")] = normal((n, d, ff))
        if ln:
            blk[("attn_norm_bias",)] = ((n, d), "zeros", 1.0)
            blk[("mlp_norm_bias",)] = ((n, d), "zeros", 1.0)
            blk[("mlp", "up_bias")] = ((n, ff), "zeros", 1.0)
            blk[("mlp", "down_bias")] = ((n, d), "zeros", 1.0)
        for k, v in blk.items():
            out[("stages", s, "blocks") + k] = v
    return [Leaf(p, *out[p]) for p in _flatten_order(list(out))]


def _flatten_order(paths: list[tuple]) -> list[tuple]:
    """Paths in the port's tree order: at every level dict keys sorted,
    and the ``stages`` list in index order."""
    def key(p):
        return tuple(str(k) if not isinstance(k, int) else f"{k:08d}" for k in p)
    return sorted(paths, key=key)


def make(m: dict, seed: int, device) -> dict:
    """The tree of weights for ``seed``: one normal draw of every element
    on ``device`` in the model's dtype, from a generator there."""
    dt = getattr(torch, m["dtype"])
    specs = leaves(m)
    total = sum(math.prod(l.shape) for l in specs)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    buf = torch.randn((total,), generator=gen, dtype=dt, device=device)
    tree: dict = {}
    off = 0
    for l in specs:
        n = math.prod(l.shape)
        t = buf[off:off + n].view(l.shape)
        off += n
        if l.init == "ones":
            t.fill_(1.0)
        elif l.init == "zeros":
            t.zero_()
        elif l.scale != 1.0:
            t.mul_(l.scale)
        _put(tree, l.path, t)
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for a, b in zip(path[:-1], path[1:]):
        if isinstance(b, int):
            lst = node.setdefault(a, [])
            while len(lst) <= b:
                lst.append({})
            node = lst
        else:
            node = node[a] if isinstance(node, list) else node.setdefault(a, {})
    node[path[-1]] = value


def get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def unit_names(m: dict) -> list[str]:
    return list(units_of_flat(m, None))


def _unit(path: tuple, layer: int | None) -> str:
    tail = ".".join(str(k) for k in (path[3:] if layer is not None else path))
    return f"L{layer}.{tail}" if layer is not None else tail


def units_of_flat(m: dict, tree) -> dict:
    """Units of a tree in the port's flat layout (``stages[s].blocks``
    stacked over each stage's layers); ``tree`` None gives the names only."""
    offs = [sum(stage_sizes(m)[:s]) for s in range(len(stage_sizes(m)))]
    out = {}
    for l in leaves(m):
        t = None if tree is None else get(tree, l.path)
        if l.stacked:
            for i in range(l.shape[0]):
                out[_unit(l.path, offs[l.path[1]] + i)] = None if t is None else t[i]
        else:
            out[_unit(l.path, None)] = t
    return out


def units_of_stage_stacked(m: dict, stage_tree, shared) -> dict:
    """Units of a pipelined state: ``stage_tree["blocks"]`` leaves stacked
    (S, Lmax, ...) over stages and layers, ``shared`` the rest."""
    sizes = stage_sizes(m)
    if len(set(sizes)) != 1:
        raise ValueError("ragged stages are not laid out here")
    out = {}
    for l in leaves(m):
        if l.stacked:
            if l.path[1] != 0:
                continue
            t = get(stage_tree, l.path[2:])
            for s in range(len(sizes)):
                for i in range(sizes[s]):
                    out[_unit(l.path, s * sizes[0] + i)] = t[s, i]
        else:
            out[_unit(l.path, None)] = get(shared, l.path)
    return {k: out[k] for k in unit_names(m)}


def unit_leaf(m: dict) -> dict[str, Leaf]:
    """The leaf each unit comes from."""
    offs = [sum(stage_sizes(m)[:s]) for s in range(len(stage_sizes(m)))]
    out = {}
    for l in leaves(m):
        if l.stacked:
            for i in range(l.shape[0]):
                out[_unit(l.path, offs[l.path[1]] + i)] = l
        else:
            out[_unit(l.path, None)] = l
    return out
