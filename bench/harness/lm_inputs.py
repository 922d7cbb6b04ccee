"""Inputs of the language-model cells, made by the benchmark from the
seed and handed alike to the program and to the reference: the weights
of a dense decoder (one draw on the device, cut into leaves) and the
token batches of each worker's stream."""

from __future__ import annotations

from harness.core import seed_of


def layout(arch: dict) -> list:
    """``(name, shape, std)`` of every leaf of a dense gated decoder, named
    by its path in the program's parameter tree; layers are stacked on a
    leading axis. A norm's scale is stored as ``w`` in ``1 + w`` (zeros)."""
    d, H, K, f, V, L = (arch["d_model"], arch["num_heads"], arch["num_kv_heads"], arch["d_ff"], arch["vocab"],
                        arch["num_layers"])
    hd = arch.get("head_dim") or d // H
    lay = "decoder.0.0."
    return [
        ("embed", (V, d), 0.02),
        ("final_norm", (d,), 0.0),
        (lay + "ln1", (L, d), 0.0),
        (lay + "attn.wq", (L, d, H * hd), d ** -0.5),
        (lay + "attn.wk", (L, d, K * hd), d ** -0.5),
        (lay + "attn.wv", (L, d, K * hd), d ** -0.5),
        (lay + "attn.wo", (L, H * hd, d), (H * hd) ** -0.5),
        (lay + "ln2", (L, d), 0.0),
        (lay + "mlp.up", (L, d, f), d ** -0.5),
        (lay + "mlp.down", (L, f, d), f ** -0.5),
        (lay + "mlp.gate", (L, d, f), d ** -0.5),
        ("lm_head", (d, V), d ** -0.5),
    ]


def make_weights(arch: dict, seed: int, device) -> dict:
    """Float32 weights by name: one normal draw on ``device`` from a
    generator seeded by ``seed``, cut into the drawn leaves in
    :func:`layout`'s order and scaled in place."""
    import torch

    leaves = layout(arch)
    total = sum(_numel(s) for _, s, std in leaves if std)
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, 1))
    flat = torch.randn((total,), generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std in leaves:
        if not std:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
            continue
        n = _numel(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def to_tree(named: dict) -> dict:
    """Dotted names to the program's nested tree (an integer part indexes
    a list)."""
    root: dict = {}
    for name, value in named.items():
        parts = name.split(".")
        node = root
        for i, p in enumerate(parts[:-1]):
            nxt = {} if not parts[i + 1].isdigit() else []
            if isinstance(node, list):
                k = int(p)
                while len(node) <= k:
                    node.append(None)
                if node[k] is None:
                    node[k] = nxt
                node = node[k]
            else:
                node = node.setdefault(p, nxt)
        last = parts[-1]
        if isinstance(node, list):
            while len(node) <= int(last):
                node.append(None)
            node[int(last)] = value
        else:
            node[last] = value
    return root


def flatten(tree, prefix: str = "") -> dict:
    """The program's nested tree to dotted names (the inverse of
    :func:`to_tree`)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def tokens(seed: int, stream: int, draw: int, shape: tuple, vocab: int, device):
    """Uniform int32 tokens in [0, vocab) for draw ``draw`` of worker
    stream ``stream``: one generator seeded by the triple."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, 2, stream, draw))
    return torch.randint(0, vocab, shape, generator=g, device=device, dtype=torch.int64).to(torch.int32)


def lm_batch(tok):
    """A next-token batch: labels are the tokens shifted left (the first
    wraps to the end), every position counts."""
    import torch

    labels = torch.cat([tok[..., 1:], tok[..., :1]], dim=-1)
    mask = torch.ones(tok.shape, dtype=torch.float32, device=tok.device)
    return {"tokens": tok, "labels": labels, "mask": mask}
