"""Inputs and weights of the language-model cells, made from the seed.

Weights are drawn on the device by one ``torch.Generator`` in two
calls (one normal draw and one uniform draw for all leaves, sliced and
scaled), in float32, the configurations' parameter dtype.  Token ids
follow a Zipf law over the model's vocabulary (rank r drawn with
probability proportional to 1 / r); training documents have
log-normal lengths.  Every draw is a function of the seed alone, so
the reference can make the same inputs again after the window.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

Leaf = Tuple[str, Tuple[int, ...], tuple]


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for a stream of the run (``tags`` name it)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_weights(leaves: Sequence[Leaf], seed: int, device) -> Dict:
    """{name: float32 tensor on ``device``}.  ``init`` of a leaf:
    ("normal", std), ("const", c) or ("uniform", lo, hi)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    sizes = {name: math.prod(shape) for name, shape, _ in leaves}
    n_norm = sum(sizes[n] for n, _, i in leaves if i[0] == "normal")
    n_unif = sum(sizes[n] for n, _, i in leaves if i[0] == "uniform")
    normal = torch.randn(n_norm, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device)
    out, on, ou = {}, 0, 0
    for name, shape, init in leaves:
        n = sizes[name]
        kind = init[0]
        if kind == "normal":
            t = normal[on:on + n].mul_(init[1])
            on += n
        elif kind == "const":
            t = torch.full((n,), float(init[1]), device=device)
        else:
            lo, hi = init[1], init[2]
            t = unif[ou:ou + n].mul_(hi - lo).add_(lo)
            ou += n
        out[name] = t.view(shape)
    return out


def zipf_cdf(vocab: int) -> np.ndarray:
    w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64)
    c = np.cumsum(w)
    return c / c[-1]


def zipf_tokens(rng: np.random.Generator, cdf: np.ndarray, n: int
                ) -> np.ndarray:
    return np.minimum(np.searchsorted(cdf, rng.random(n)),
                      len(cdf) - 1).astype(np.int32)


def documents(seed: int, vocab: int, n_tokens: int, median: float,
              sigma: float, lo: int, hi: int) -> List[np.ndarray]:
    """Documents of log-normal lengths (``median``, ``sigma``, clipped
    to [lo, hi]) of Zipfian ids, at least ``n_tokens`` tokens in all."""
    rng = np.random.default_rng(sub_seed(seed, 2))
    lengths = []
    while sum(lengths) < n_tokens:
        lengths.extend(np.clip(np.rint(rng.lognormal(
            math.log(median), sigma, 1024)), lo, hi).astype(int).tolist())
    total = np.cumsum(lengths)
    k = int(np.searchsorted(total, n_tokens)) + 1
    lengths = lengths[:k]
    flat = zipf_tokens(rng, zipf_cdf(vocab), int(sum(lengths)))
    cuts = np.cumsum(lengths)[:-1]
    return np.split(flat, cuts)


def prompt_tokens(seed: int, stream: int, index: int, rows: int,
                  length: int, cdf, device):
    """Batch ``index``'s prompts in ``stream`` (the window's, or
    set-up's), [rows, length] int64 on ``device`` (``cdf``: ``zipf_cdf``
    as a float64 tensor there)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, 3, stream, index))
    u = torch.rand((rows, length), generator=gen, device=device,
                   dtype=torch.float64)
    return torch.clamp(torch.searchsorted(cdf, u), max=cdf.numel() - 1)


def prompt_lengths(n: int, median: float, sigma: float, lo: int, hi: int
                   ) -> List[int]:
    """The ``n`` lengths at the mid-quantiles (i + 1/2) / n of a
    log-normal (``median``, ``sigma``) clipped to [lo, hi]: the same set
    for every seed, so that a seed changes the order of the work and
    not its amount."""
    from statistics import NormalDist
    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    return [int(min(hi, max(lo, round(median * math.exp(sigma * x)))))
            for x in z]


def to_tree(paths: Dict[str, tuple], flat: Dict) -> Dict:
    """The nested tree that ``paths`` (name -> key path) lays out."""
    tree: Dict = {}
    for name, path in paths.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[name]
    return tree


def from_tree(paths: Dict[str, tuple], tree: Dict) -> Dict:
    out = {}
    for name, path in paths.items():
        node = tree
        for k in path:
            node = node[k]
        out[name] = node
    return out


def leaf_norms(flat: Dict) -> Dict:
    """{name: float64 CPU tensor}: the L2 norm of each leaf, of each
    layer's slice where the leaf is stacked over the layers (its name
    starts with ``layers.``)."""
    out = {}
    for name, t in flat.items():
        t = t.detach().float()
        n = (t.flatten(1).norm(dim=1) if name.startswith("layers.")
             else t.norm().reshape(1))
        out[name] = n.double().cpu()
    return out


def leaf_gaps(prog: Dict, ref: Dict, keep: Dict | None = None
              ) -> Tuple[np.ndarray, List[str]]:
    """|norm_p - norm_r| / max(norm_r, the median leaf's norm_r) of
    each leaf (layer slice) that ``keep`` marks (all where None), and
    the leaves' names."""
    import torch
    names, p_all, r_all = [], [], []
    for name in sorted(ref):
        mask = keep[name] if keep is not None else torch.ones_like(
            ref[name], dtype=torch.bool)
        for i in range(ref[name].numel()):
            if mask[i]:
                names.append(f"{name}[{i}]")
                p_all.append(float(prog[name][i]))
                r_all.append(float(ref[name][i]))
    r = np.asarray(r_all)
    gaps = np.abs(np.asarray(p_all) - r) / np.maximum(r, float(np.median(r)))
    return np.where(np.isfinite(gaps), gaps, np.inf), names


def worst_leaf_gap(prog: Dict, ref: Dict, keep: Dict | None = None
                   ) -> Tuple[float, str]:
    """The largest of ``leaf_gaps`` and which leaf it is."""
    gaps, names = leaf_gaps(prog, ref, keep)
    i = int(np.argmax(gaps))
    return float(gaps[i]), names[i]
