"""LanguageModel: init / prefill / decode step over the layer stack, with
SkipGPT routing and cross-layer KV reuse threaded through every layer.

Counterpart of the JAX package's ``models/model.py`` (inference entry
points).  Parameters are a nested dict named after the reference's pytree
paths, except that the scan-stacked ``stack.stage0`` / ``stack.stages``
leaves become one list ``blocks`` of per-layer dicts (``bridge.py`` maps
path to path).  ``LanguageModel`` owns them as ``nn.Module`` parameters.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kvcache import paged as paged_mod
from repro_torch.models import layers, transformer


def resolve_device(device) -> torch.device:
    """The entry points' device: ``cuda`` unless the caller asks for the
    CPU.  Asking for CUDA where there is none raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available (pass device='cpu' to run the plain "
                           "versions on the CPU)")
    return device


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict:
    """Parameters with the reference's shapes and distributions, drawn from
    ``generator`` and built directly on ``device``."""
    transformer.check_supported(cfg)
    p = {"embed": layers.embedding_init(generator, cfg, device),
         "blocks": [transformer.block_init(generator, cfg, device)
                    for _ in range(cfg.num_layers)],
         "final_norm": layers.norm_init(cfg.d_model, cfg, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.linear_init(generator, cfg.d_model,
                                          cfg.vocab_size, cfg, device,
                                          scale=0.02)
    return p


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------

def _pad_cache_to(cache: List[Dict], T: int, pad_to: int) -> List[Dict]:
    """Grow each layer's [B, T, Hkv, dh] KV view to pad_to (decode room);
    a Mamba layer's conv histories and state are left as they are."""
    out = []
    for ce in cache:
        grown = {}
        for name, kv in ce.items():
            if name not in ("k", "v"):
                grown[name] = kv
                continue
            g = torch.zeros((kv.shape[0], pad_to) + tuple(kv.shape[2:]),
                            dtype=kv.dtype, device=kv.device)
            g[:, :T] = kv
            grown[name] = g
        out.append(grown)
    return out


def prefill(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            pad_to: Optional[int] = None,
            last_index: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, List[Dict], Dict]:
    """tokens [B, T] -> (last-position logits [B, V], per-layer cache
    [{"k", "v"}: [B, pad_to or T, Hkv, dh]] or, for a Mamba stack,
    [{"conv_x", "conv_bc", "ssm"}], stats).

    ``last_index``: optional [B] index of each sequence's final *real*
    token — bucketed prefill right-pads prompts to a shared length, and the
    next-token logits must come from the real last position."""
    transformer.check_supported(cfg)
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, T)
    x = layers.embed(params["embed"], tokens)
    x, stats, cache, sq = transformer.stack_forward(params["blocks"], x,
                                                    positions, cfg)
    if last_index is None:
        xl = x[:, -1:]
        sql = None if sq is None else sq[:, -1:]
    else:
        rows = torch.arange(B, device=x.device)
        idx = torch.as_tensor(last_index, device=x.device).long()
        xl = x[rows, idx][:, None]
        sql = None if sq is None else sq[rows, idx][:, None]
    x = layers.norm_apply(params["final_norm"], xl, cfg, stats=sql)
    logits = layers.unembed(params["embed"], params.get("lm_head"), x,
                            cfg)[:, 0]
    if pad_to is not None and pad_to > T:
        cache = _pad_cache_to(cache, T, pad_to)
    return logits, cache, stats


def decode_step(params: Dict, cache: List[Dict], tokens: torch.Tensor,
                t, cfg: ModelConfig) -> Tuple[torch.Tensor, List[Dict], Dict]:
    """One token per sequence.  tokens [B, 1]; t: [B] or scalar position
    (lock-step).  The caches are updated IN PLACE (the JAX engine donates
    them).  Returns (logits [B, V], cache, stats) with ``attn_gate`` [L, B]
    (``ssm_gate`` for a Mamba stack)."""
    transformer.check_supported(cfg)
    B = tokens.shape[0]
    t = torch.as_tensor(t, dtype=torch.int32, device=tokens.device)
    t = t.reshape(-1).expand(B).contiguous()
    pos = t[:, None]
    x = layers.embed(params["embed"], tokens)
    x, cache, stats, sq = transformer.stack_decode(params["blocks"], cache, x,
                                                   t, pos, cfg)
    x = layers.norm_apply(params["final_norm"], x, cfg, stats=sq)
    logits = layers.unembed(params["embed"], params.get("lm_head"), x, cfg)
    return logits[:, 0], cache, stats


def paged_decode_step(params: Dict, store: Dict, tokens: torch.Tensor,
                      t, block_table: torch.Tensor, fill: torch.Tensor,
                      cfg: ModelConfig,
                      commit_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict, Dict]:
    """One token for every slot against the paged KV store.

    The dense-pool twin of ``decode_step``: past tokens' KV lives in the
    shared store-once entry stream (``kvcache/paged.py``).  ``block_table``
    [B, J] and ``fill`` [B] come from the host-side ``PageAllocator``, which
    has guaranteed page capacity for this step's ≤ n_attn_layers appends.
    Slots with ``fill == 0`` are inactive: they decode garbage but commit
    nothing; ``commit_mask`` [B] overrides that default.  The store is
    updated IN PLACE.  Returns (logits [B, V], store, stats) with
    ``attn_gate`` [L, B]."""
    transformer.check_supported(cfg)
    if not paged_mod.can_page(cfg):
        raise ValueError(f"{cfg.name}: not a pageable stack")
    B = tokens.shape[0]
    dev = tokens.device
    t = torch.as_tensor(t, dtype=torch.int32, device=dev)
    t = t.reshape(-1).expand(B).contiguous()
    pos = t[:, None]
    block_table = block_table.to(device=dev, dtype=torch.int32)
    fill = fill.to(device=dev, dtype=torch.int32)
    x = layers.embed(params["embed"], tokens)

    # resolve the page chains' metadata once per step (the store is frozen
    # until the end-of-step commit; the kernel walks the pages itself)
    kv_dtype = paged_mod.infer_kv_dtype(store, cfg)
    ctx = paged_mod.gather_view(store, block_table, with_kv=False)
    E = ctx["pos"].shape[1]
    ctx["in_fill"] = (torch.arange(E, device=dev)[None, :]
                      < fill[:, None])
    ctx["k_pages"], ctx["v_pages"] = store["k_pages"], store["v_pages"]
    ctx["block_table"] = block_table
    if kv_dtype is not None:
        ctx["k_scales"], ctx["v_scales"] = store["k_scales"], store["v_scales"]

    x, (buf_k, buf_v), stats, sq = transformer.stack_decode_paged(
        params["blocks"], x, pos, cfg, ctx)
    if commit_mask is None:
        commit_mask = fill > 0
    paged_mod.commit_decode(store, buf_k, buf_v, stats["attn_gate"], t,
                            block_table, fill, commit_mask.to(dev), cfg,
                            kv_dtype=kv_dtype)
    x = layers.norm_apply(params["final_norm"], x, cfg, stats=sq)
    logits = layers.unembed(params["embed"], params.get("lm_head"), x, cfg)
    return logits[:, 0], store, stats


# ---------------------------------------------------------------------------
# nn.Module owner
# ---------------------------------------------------------------------------

class _Tree(nn.Module):
    """Registers a nested dict/list of tensors as frozen parameters whose
    names are the dict paths ("blocks.3.mixer.router.w")."""

    def __init__(self, tree):
        super().__init__()
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            if isinstance(v, torch.Tensor):
                self.register_parameter(str(k), nn.Parameter(
                    v, requires_grad=False))
            else:
                self.add_module(str(k), _Tree(v))

    def as_tree(self, like):
        items = like.items() if isinstance(like, dict) else enumerate(like)
        out = {k: (getattr(self, str(k)) if isinstance(v, torch.Tensor)
                   else getattr(self, str(k)).as_tree(v)) for k, v in items}
        return out if isinstance(like, dict) else [out[i]
                                                    for i in range(len(like))]


class LanguageModel(nn.Module):
    """The model's parameters plus its inference entry points.

    ``params`` (a nested dict, e.g. from ``bridge.from_reference``) is moved
    to ``device``; without it ``init_params`` draws them there from a
    ``torch.Generator`` seeded with ``seed``.  ``device`` defaults to
    ``cuda`` and raises where CUDA is missing."""

    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_params(cfg, gen, self.device)
        else:
            params = _to_device(params, self.device)
        self._layout = params
        self.tree = _Tree(params)

    def params(self) -> Dict:
        """The parameters as the nested dict the layer functions take."""
        return self.tree.as_tree(self._layout)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, pad_to: Optional[int] = None,
                last_index=None):
        return prefill(self.params(), tokens.to(self.device), self.cfg,
                       pad_to=pad_to, last_index=last_index)

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, t):
        return decode_step(self.params(), cache, tokens.to(self.device), t,
                           self.cfg)

    @torch.no_grad()
    def paged_decode_step(self, store, tokens: torch.Tensor, t,
                          block_table, fill, commit_mask=None):
        return paged_decode_step(self.params(), store,
                                 tokens.to(self.device), t, block_table,
                                 fill, self.cfg, commit_mask=commit_mask)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
