"""Carry keys and ciphertexts between the JAX package and the port.

The port's dataclasses (:mod:`repro_torch.core.cipher`) have the JAX
package's field names and shapes. :func:`from_numpy` builds one from numpy
arrays — for example ``np.asarray(evk.ax_ev)`` for each field of a JAX
``EvalKey`` — on a device; :func:`to_numpy` gives the arrays back, words
as uint32 or uint64. Both sides can then run HE Mul on the same operands.
A uint64 array is a β = 2^64 word array and becomes int64 bit patterns;
on the way back an int64 tensor is a word only at β = 2^64, so
:func:`to_numpy` takes the word size.

The LM side's pair, :func:`lm_params_from_numpy` and
:func:`lm_params_to_numpy`, carries a model's parameter tree (numpy arrays
in the JAX package's layout: ``layers`` stacked for ``lax.scan``,
``groups`` + ``tail`` for a hybrid pattern, ``layers_list``, or ``enc`` /
``dec``) to the port's :class:`~repro_torch.models.LM` and back;
:func:`lm_cache_from_numpy` and :func:`lm_cache_to_numpy` do the same for
a decode cache (``stacked``, ``groups`` + ``tail``, ``list`` or ``dec``).
A bfloat16 array (``ml_dtypes.bfloat16``) becomes a ``torch.bfloat16``
tensor of the same bits. :func:`opt_state_from_numpy` and
:func:`opt_state_to_numpy` carry AdamW's state the same way.

The training side reads the same mapping on tensors: :func:`lm_order`
lists parameter names in the reference's flatten order (the order its
gradient norm sums and its compressed all-reduce numbers the leaves),
:func:`lm_stack` / :func:`lm_unstack` join per-layer tensors into the
reference's leaves and split them again, and :func:`lm_tree` /
:func:`lm_untree` nest those leaves as the reference's tree (what a
checkpoint stores). :func:`lm_leaves` names the parameters behind each
reference leaf, and :func:`lm_cache_tree` nests a cache's tensors as the
reference's cache tree (the placement rules read both). Weights keep their ``(d_in, d_out)``
orientation, so nothing is transposed.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from repro_torch.core.context import resolve_device

__all__ = ["from_numpy", "to_numpy", "lm_params_from_numpy",
           "lm_params_to_numpy", "lm_cache_from_numpy", "lm_cache_to_numpy",
           "lm_order", "lm_leaves", "lm_stack", "lm_unstack", "lm_tree",
           "lm_untree", "lm_cache_tree",
           "opt_state_from_numpy", "opt_state_to_numpy"]


def from_numpy(cls, fields: dict, device: str | torch.device = "cuda"):
    """An instance of dataclass `cls` from {field name: value}; numpy
    arrays become tensors on `device` (uint32 and uint64 as int32 and
    int64 bit patterns)."""
    dev = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        if isinstance(v, np.ndarray):
            if v.dtype == np.uint32:
                v = v.view(np.int32)
            elif v.dtype == np.uint64:
                v = v.view(np.int64)
            v = torch.from_numpy(np.array(v)).to(dev)   # a writable copy
        kwargs[f.name] = v
    return cls(**kwargs)


def to_numpy(obj, beta_bits: int = 32) -> dict:
    """{field name: value} of a port dataclass; int32 words come back as
    uint32 arrays, and at ``beta_bits=64`` int64 words as uint64 arrays;
    other tensors keep their dtype."""
    if beta_bits not in (32, 64):
        raise ValueError(f"beta_bits is 32 or 64; got {beta_bits}")
    words = {np.dtype(np.int32): np.uint32}
    if beta_bits == 64:
        words[np.dtype(np.int64)] = np.uint64
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            a = v.cpu().numpy()
            v = a.view(words[a.dtype]) if a.dtype in words else a
        out[f.name] = v
    return out


# ---- the LM side -----------------------------------------------------------

def _lm_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16))).to(device) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _lm_array(t: torch.Tensor) -> np.ndarray:
    """A copy of `t` on the host (decode writes caches in place)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return np.array(t.view(torch.int16).numpy()).view(_bf16())
    return np.array(t.numpy())


def _bf16() -> np.dtype:
    """numpy's bfloat16, which exists once the JAX package (the consumer
    of these arrays) has loaded ml_dtypes; the port never imports it."""
    mod = sys.modules.get("ml_dtypes")
    if mod is None:
        raise RuntimeError("a bfloat16 array for the JAX package needs "
                           "ml_dtypes loaded (import jax first)")
    return np.dtype(mod.bfloat16)


def _flatten(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of nested dicts and lists."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple))
             else None)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _unflatten(flat: dict, lists: tuple = ()):
    """Nested dicts from dotted paths; a node whose keys are all digits is a
    list; each name in `lists` is a top-level list even when empty."""
    root: dict = {name: {} for name in lists}
    for path, v in flat.items():
        node = root
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    out = listify(root)
    return {k: ([] if k in lists and v == {} else v) for k, v in out.items()}


def _groups(cfg) -> tuple[int, int]:
    """(pattern length G, groups) of a hybrid stack; its tail follows."""
    g = len(cfg.layer_pattern)
    return g, cfg.n_layers // g


def _layout(cfg) -> str:
    if cfg.uniform_layers and cfg.scan_layers:
        return "stacked"
    if cfg.layer_pattern and cfg.scan_layers:
        return "groups"
    return "list"


def _to_per_layer(flat: dict, cfg, stacked: str, listed: str, out: str
                  ) -> dict:
    """The reference's names -> `out`.i.rest, one entry a layer."""
    res = {}
    for name, a in flat.items():
        head, _, rest = name.partition(".")
        if head == stacked:
            for i in range(a.shape[0]):
                res[f"{out}.{i}.{rest}"] = a[i]
        elif head == "groups":
            g, _ = _groups(cfg)
            sub, _, rest = rest.partition(".")
            for n in range(a.shape[0]):
                res[f"{out}.{n * g + int(sub[3:])}.{rest}"] = a[n]
        elif head == "tail":
            g, n_groups = _groups(cfg)
            i, _, rest = rest.partition(".")
            res[f"{out}.{n_groups * g + int(i)}.{rest}"] = a
        elif head == listed:
            res[f"{out}.{rest}"] = a
        else:
            res[name] = a
    return res


def _from_per_layer(flat: dict, cfg, stacked: str, listed: str, out: str,
                    stack=np.stack) -> dict:
    """The inverse of :func:`_to_per_layer` in `cfg`'s layout (`stack`
    joins a stacked leaf's layers: np.stack for arrays, torch.stack for
    tensors)."""
    layout = _layout(cfg)
    res, per = {}, {}
    for name, a in flat.items():
        head, _, rest = name.partition(".")
        if head != out:
            res[name] = a
            continue
        i, _, rest = rest.partition(".")
        per[(int(i), rest)] = a
    if layout == "list":
        res.update({f"{listed}.{i}.{rest}": a for (i, rest), a in per.items()})
        return res
    if layout == "stacked":
        for rest in {r for _, r in per}:
            res[f"{stacked}.{rest}"] = stack(
                [per[(i, rest)] for i in range(cfg.n_layers)])
        return res
    g, n_groups = _groups(cfg)
    for (i, rest), a in per.items():
        if i >= n_groups * g:
            res[f"tail.{i - n_groups * g}.{rest}"] = a
        elif i < g:
            res[f"groups.sub{i}.{rest}"] = stack(
                [per[(n * g + i, rest)] for n in range(n_groups)])
    return res


def lm_params_from_numpy(tree: dict, cfg, device: str | torch.device = "cuda"):
    """The port's :class:`~repro_torch.models.LM` holding the JAX package's
    parameter tree `tree` (numpy arrays in any of its layouts) on
    `device`. Every name, shape and dtype must match the model's."""
    from repro_torch.models import init_params
    dev = resolve_device(device)
    flat = _to_per_layer(_flatten(tree), cfg, "layers", "layers_list",
                         "layers")
    model = init_params(cfg, torch.Generator(device=dev), dev)
    own = model.state_dict()
    if set(flat) != set(own):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(own) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(own))}")
    with torch.no_grad():
        for name, t in own.items():
            src = _lm_tensor(flat[name], dev)
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(f"{name}: {tuple(src.shape)} {src.dtype} "
                                 f"against {tuple(t.shape)} {t.dtype}")
            t.copy_(src)
    return model


def lm_params_to_numpy(model, cfg) -> dict:
    """The JAX package's parameter tree of `model`, in `cfg`'s layout."""
    flat = {k: _lm_array(v) for k, v in model.state_dict().items()}
    flat = _from_per_layer(flat, cfg, "layers", "layers_list", "layers")
    return _unflatten(flat, _lists(cfg))


def lm_cache_from_numpy(tree: dict, cfg, device: str | torch.device = "cuda"
                        ) -> dict:
    """The port's cache (``{"list": [...]}`` or ``{"dec": [...]}``) from
    the JAX package's cache `tree` of numpy arrays, on `device`."""
    dev = resolve_device(device)
    flat = _to_per_layer(_flatten(tree), cfg, "stacked", "list", "list")
    return _unflatten({k: _lm_tensor(a, dev) for k, a in flat.items()})


def lm_cache_to_numpy(cache: dict, cfg) -> dict:
    """The JAX package's cache tree of the port's `cache`, in `cfg`'s
    layout."""
    flat = {k: _lm_array(v) for k, v in _flatten(cache).items()}
    flat = _from_per_layer(flat, cfg, "stacked", "list", "list")
    return _unflatten(flat, _lists(cfg))


def lm_cache_tree(cache: dict, cfg) -> dict:
    """The reference's cache tree of the port's `cache` tensors, in
    `cfg`'s layout (stacked leaves are new tensors)."""
    flat = _from_per_layer(_flatten(cache), cfg, "stacked", "list", "list",
                           stack=torch.stack)
    return _unflatten(flat, _lists(cfg))


# ---- the training side -----------------------------------------------------

def _lists(cfg) -> tuple:
    return ("tail",) if _layout(cfg) == "groups" else ()


def _path_key(name: str) -> tuple:
    """A dotted path's place in a pytree flatten: dict keys sorted as
    strings, list entries by index."""
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in name.split("."))


def lm_leaves(names, cfg) -> dict:
    """{reference leaf (dotted): the parameter name behind it, or the list
    of its layers' names for a stacked leaf}."""
    return _from_per_layer({n: n for n in names}, cfg, "layers",
                           "layers_list", "layers", stack=list)


def lm_order(names, cfg) -> list:
    """Parameter names in the reference's flatten order of their leaves
    (a stacked leaf's layers one after another)."""
    flat = lm_leaves(names, cfg)
    out = []
    for ref in sorted(flat, key=_path_key):
        out.extend(flat[ref] if isinstance(flat[ref], list) else
                   [flat[ref]])
    return out


def lm_stack(named: dict, cfg) -> dict:
    """{reference leaf (dotted): tensor} of {parameter name: tensor}, in
    the reference's flatten order; stacked leaves are new tensors."""
    flat = _from_per_layer(named, cfg, "layers", "layers_list", "layers",
                           stack=torch.stack)
    return {k: flat[k] for k in sorted(flat, key=_path_key)}


def lm_unstack(flat: dict, cfg) -> dict:
    """{parameter name: tensor} of {reference leaf: tensor}; a stacked
    leaf's layers are views of it."""
    return _to_per_layer(flat, cfg, "layers", "layers_list", "layers")


def lm_tree(named: dict, cfg) -> dict:
    """The reference's nested tree of {parameter name: tensor}."""
    return _unflatten(lm_stack(named, cfg), _lists(cfg))


def lm_untree(tree: dict, cfg) -> dict:
    """{parameter name: tensor} of the reference's nested tree."""
    return lm_unstack(_flatten(tree), cfg)


def _fields(state) -> tuple:
    if isinstance(state, dict):
        return state["step"], state["mu"], state["nu"]
    return state.step, state.mu, state.nu


def opt_state_from_numpy(state, cfg, device: str | torch.device = "cuda"):
    """The port's :class:`~repro_torch.optim.OptState` of the JAX
    package's AdamW state `state` (an ``OptState`` or a dict with
    ``step``, ``mu`` and ``nu``; numpy leaves in any of the layouts) on
    `device`."""
    from repro_torch.optim import OptState
    dev = resolve_device(device)
    step, mu, nu = _fields(state)

    def moments(tree):
        flat = _to_per_layer(_flatten(tree), cfg, "layers", "layers_list",
                             "layers")
        return {k: _lm_tensor(a, dev) for k, a in flat.items()}

    return OptState(step=torch.tensor(int(np.asarray(step)),
                                      dtype=torch.int32, device=dev),
                    mu=moments(mu), nu=moments(nu))


def opt_state_to_numpy(state, cfg) -> dict:
    """{"step", "mu", "nu"} of the port's AdamW state: the JAX package's
    fields, numpy leaves in `cfg`'s layout."""
    def moments(named):
        flat = {k: _lm_array(v) for k, v in named.items()}
        return _unflatten(_from_per_layer(flat, cfg, "layers", "layers_list",
                                          "layers"), _lists(cfg))

    return {"step": np.asarray(int(state.step), np.int32),
            "mu": moments(state.mu), "nu": moments(state.nu)}
