"""LoRA / DoRA adapters (port of ``spatialrgpt_tpu/train/lora.py``).

Low-rank adapters on the decoder's projections, trained with the base
frozen, saved apart from it, and mergeable into it for serving.  An
adapter of a projection with an (out, in) weight holds a (in, r) and b
(r, out), the reference's layout (its kernels are (in, out)), so
``utils/weights.py::load_adapters_from_jax`` copies them as they are;
``LoraAdapters`` keeps them as ``nn.Parameter``s under the projection's
module name, a module of its own that an optimizer's ``adapters`` group
takes (``train/optimizer.py``).

``apply_lora`` returns a view of the base: a copy of the module tree down to
each adapted projection, every tensor shared, the base itself untouched (the
reference returns a new tree).  Merged, an adapted projection becomes a
``MergedLinear`` holding W + a b * scale (or DoRA's renormalised form), a
``QuantLinear`` dequantized first; unmerged, it is a copy of the projection
that carries the factors as ``lora`` (``ops/layers.py::LoraBranch``), and
``ops/layers.py::linear`` adds the side branch ``((x a) b) * scale`` while
the base stays on its own (int8) route in the forward and the backward:
the QLoRA memory contract that merging cannot keep at 8B.

``save_adapters`` / ``load_adapters`` use ``torch.save``, as the port's
trainer does: the reference's ``save_pytree`` (npz) is not ported.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from spatialrgpt_tpu_torch.ops.layers import LoraBranch, MergedLinear, QuantLinear
from spatialrgpt_tpu_torch.utils.export import LLAMA_PROJECTIONS

# the reference's target names (its kernels' keys; utils/export.py maps them
# to the port's module names)
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


@dataclass(frozen=True)
class LoraConfig:
    """Field-for-field twin of the reference's ``LoraConfig``."""

    r: int = 64
    alpha: float = 16.0
    dropout: float = 0.0  # applied by the caller on inputs if desired
    targets: tuple = DEFAULT_TARGETS
    use_dora: bool = False

    @property
    def scale(self) -> float:
        return self.alpha / self.r


class LoraPair(nn.Module):
    """One projection's adapter: a (in, r), b (r, out) and, for DoRA, the
    learned magnitude m (out,) of each output channel."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, m: Optional[torch.Tensor] = None):
        super().__init__()
        self.a, self.b = nn.Parameter(a), nn.Parameter(b)
        self.m = None if m is None else nn.Parameter(m)


class LoraAdapters(nn.Module):
    """The adapters of a model's projections, by module name (relative to the
    decoder, e.g. ``model.layers.0.self_attn.q_proj``)."""

    def __init__(self, pairs: Dict[str, LoraPair]):
        super().__init__()
        # a module's name may not hold '.'
        self.pairs = nn.ModuleDict({name.replace(".", "/"): pair for name, pair in pairs.items()})

    def items(self) -> Iterator[Tuple[str, LoraPair]]:
        for key, pair in self.pairs.items():
            yield key.replace("/", "."), pair

    def __len__(self) -> int:
        return len(self.pairs)


def _projections(root: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """(name, module) of every float or quantized projection, in order (the
    reference's ``_walk_kernels``, which takes ``kernel`` and ``kernel_q``
    alike, so adapters fit a bf16 and a quantized base the same)."""
    for name, mod in root.named_modules():
        if isinstance(mod, (nn.Linear, QuantLinear, MergedLinear)):
            yield name, mod


def _is_expert(name: str) -> bool:
    """An MoE expert's projection (``...block_sparse_moe.experts.{e}.w1``)."""
    return name.rpartition(".")[0].rpartition(".")[0].endswith("experts")


def _is_target(name: str, targets) -> bool:
    """The reference's rule (a target among the kernel path's parts) by the
    port's names: an expert's w1 / w3 / w2 count as its ``gate`` / ``up`` /
    ``down`` (``utils/weights.py::MOE_PROJECTIONS``); the router
    (``block_sparse_moe.gate``, the reference's ``router``) is never one."""
    from spatialrgpt_tpu_torch.utils.weights import MOE_PROJECTIONS

    leaf = name.rpartition(".")[2]
    if _is_expert(name):
        return any(MOE_PROJECTIONS.get(t) == leaf for t in targets)
    leaves = {LLAMA_PROJECTIONS[t][1].rpartition(".")[2] if t in LLAMA_PROJECTIONS else t for t in targets}
    return leaf in leaves


def _weight(mod: nn.Module) -> torch.Tensor:
    """The (out, in) weight in f32 (a ``QuantLinear`` dequantized)."""
    return mod.dequantized(torch.float32) if isinstance(mod, QuantLinear) else mod.weight.float()


def _shape(mod: nn.Module) -> Tuple[int, int]:
    """(in, out), the reference's (fi, fo)."""
    if isinstance(mod, QuantLinear):
        return mod.in_features, mod.out_features
    return mod.weight.shape[1], mod.weight.shape[0]


@torch.no_grad()
def init_lora(llm: nn.Module, lcfg: LoraConfig, generator: torch.Generator, dtype=torch.float32) -> LoraAdapters:
    """An adapter for every targeted projection of ``llm`` (float or
    quantized): a ~ N(0, 1 / fi) drawn from ``generator`` on its device, b = 0
    (the identity at the start); DoRA's m = the column norms of the weight.
    The adapters lie on the weights' device."""
    pairs = {}
    for name, mod in _projections(llm):
        if not _is_target(name, lcfg.targets):
            continue
        fi, fo = _shape(mod)
        dev = mod.q.device if isinstance(mod, QuantLinear) else mod.weight.device
        a = torch.randn((fi, lcfg.r), generator=generator, device=generator.device) * fi**-0.5
        m = torch.linalg.vector_norm(_weight(mod), dim=1).to(dtype) if lcfg.use_dora else None
        pairs[name] = LoraPair(a.to(dev, dtype), torch.zeros((lcfg.r, fo), dtype=dtype, device=dev), m)
    return LoraAdapters(pairs)


def replace_modules(root: nn.Module, subs: Dict[str, nn.Module]) -> nn.Module:
    """A view of ``root`` in which each module named in ``subs`` is replaced:
    the modules on the way to them are shallow copies (their child tables
    copied), every other module and every tensor is shared, and ``root``
    stays as it is."""
    children: Dict[str, Dict[str, nn.Module]] = {}
    for name, sub in subs.items():
        head, _, rest = name.partition(".")
        children.setdefault(head, {})[rest] = sub
    out = copy.copy(root)
    out._modules = dict(root._modules)
    for head, rest in children.items():
        out._modules[head] = rest[""] if "" in rest else replace_modules(root._modules[head], rest)
    return out


def _merged(mod: nn.Module, pair: LoraPair, lcfg: LoraConfig, dtype) -> MergedLinear:
    """W + (a b).T * scale in f32 (DoRA: each output channel renormalised to
    m), cast to ``dtype`` (default: the weight's, bf16 for a quantized one)."""
    w = _weight(mod) + (pair.a.float() @ pair.b.float()).T * lcfg.scale
    if lcfg.use_dora and pair.m is not None:
        w = w / (torch.linalg.vector_norm(w, dim=1, keepdim=True) + 1e-6) * pair.m.float()[:, None]
    out_dtype = dtype or (torch.bfloat16 if isinstance(mod, QuantLinear) else mod.weight.dtype)
    return MergedLinear(w.to(out_dtype), mod.bias)


def apply_lora(llm: nn.Module, adapters: LoraAdapters, lcfg: LoraConfig, dtype=None, merge: bool = True) -> nn.Module:
    """A view of ``llm`` with the adapters applied: merged (each adapted
    projection a ``MergedLinear``, computed here with the adapters'
    gradients) or, with ``merge=False``, as the side branch that ``linear``
    adds (the base weights are never rewritten).  DoRA needs the merged form
    (its column norms are of W + a b).  An MoE expert always takes the merged
    form, as the reference's (``lora.py:135-139``): a merged expert is a bf16
    (out, in) tensor per layer and projection, so a decoder whose experts
    all train holds them all for the step."""
    if not merge and lcfg.use_dora:
        raise ValueError("DoRA requires merged application (merge=True)")
    mods = dict(_projections(llm))
    subs = {}
    for name, pair in adapters.items():
        mod = mods[name]
        if merge or _is_expert(name):
            subs[name] = _merged(mod, pair, lcfg, dtype)
        else:
            sub = copy.copy(mod)
            sub.lora = LoraBranch(pair.a, pair.b, lcfg.scale)
            subs[name] = sub
    return replace_modules(llm, subs)


@torch.no_grad()
def merge_lora(llm: nn.Module, adapters: LoraAdapters, lcfg: LoraConfig) -> nn.Module:
    """The adapters folded into the base weights for serving (a view; the
    base is untouched)."""
    return apply_lora(llm, adapters, lcfg)


def save_adapters(path: str, adapters: LoraAdapters, lcfg: LoraConfig) -> None:
    tensors = {name: {k: v.detach().cpu() for k, v in pair.named_parameters()} for name, pair in adapters.items()}
    torch.save({"adapters": tensors, "config": {"r": lcfg.r, "alpha": lcfg.alpha}}, path)


def load_adapters(path: str, device=None) -> LoraAdapters:
    saved = torch.load(path, map_location=device or "cpu")
    return LoraAdapters({name: LoraPair(t["a"], t["b"], t.get("m")) for name, t in saved["adapters"].items()})
