"""Architecture & shape configuration system.

Every assigned architecture is a frozen :class:`ArchConfig` registered under
its public id (``--arch <id>``). Shapes are the four assigned input regimes.
``reduced()`` yields a family-preserving tiny config for CPU smoke tests;
the FULL configs are exercised only via the dry-run (ShapeDtypeStruct, no
allocation).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, List, Optional, Tuple

VOCAB_PAD_MULTIPLE = 256


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    every_n_layers: int = 1      # MoE replaces the MLP on layers where
                                 # (layer_idx % every_n_layers) == moe_offset
    moe_offset: int = 0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) mixer configuration."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Jamba-style interleave: one attention layer per ``attn_period``."""
    attn_period: int = 8
    attn_offset: int = 4         # Jamba: attention at index 4 of each period


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 24
    enc_seq: int = 1500          # whisper: 1500 frame embeddings (stub)


# ---------------------------------------------------------------------------
# ArchConfig
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | audio | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0              # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    enc_dec: Optional[EncDecConfig] = None
    frontend: Optional[str] = None       # None | audio_stub | patch_stub
    n_prefix_tokens: int = 0             # stub frontend prefix length
    positional: str = "rope"             # rope | sinusoidal | nope
    grad_accum: int = 4                  # microbatches per train step (sized
                                         # so remat residuals fit 16GiB HBM)
    source: str = ""
    routed_experts: int = 0              # the router's width where each MoE
                                         # layer holds only moe.n_experts of
                                         # them (0: it holds all it routes to)
    shared_expert_ff: int = 0            # a SwiGLU expert of this width that
                                         # every token passes through (0: none)
    embedding_multiplier: float = 1.0    # muP: the embedded tokens × this
    residual_multiplier: float = 1.0     # muP: each mixer's and feed-forward
                                         # part's output × this before its
                                         # residual add
    attention_multiplier: float = 0.0    # muP: attention's softmax scale
                                         # (0: 1/sqrt(head_dim))
    ssm_conv_bias: bool = False          # a bias in the Mamba-2 convolution

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def n_routed(self) -> int:
        """The experts each MoE layer routes over, held here or not."""
        return self.routed_experts or self.moe.n_experts

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kinds(self) -> List[str]:
        """Per-layer mixer/mlp kind string, e.g. 'attn+mlp', 'ssm+moe'."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                mixer = "ssm"
            elif self.hybrid is not None:
                h = self.hybrid
                mixer = "attn" if (i % h.attn_period) == h.attn_offset else "ssm"
            else:
                mixer = "attn"
            if self.moe is not None and (i % self.moe.every_n_layers) == self.moe.moe_offset:
                ff = "moe"
            elif self.d_ff > 0:
                ff = "mlp"
            else:
                ff = "none"  # e.g. mamba2: the SSD mixer is the whole block
            kinds.append(f"{mixer}+{ff}")
        return kinds

    def scan_groups(self) -> Tuple[List[str], int]:
        """Return (pattern, n_repeat): the layer stack is `pattern * n_repeat`.

        Models scan over n_repeat with the pattern unrolled inside, keeping
        HLO size O(len(pattern)) rather than O(n_layers).
        """
        kinds = self.layer_kinds()
        for plen in range(1, len(kinds) + 1):
            if len(kinds) % plen:
                continue
            pat = kinds[:plen]
            if pat * (len(kinds) // plen) == kinds:
                return pat, len(kinds) // plen
        return kinds, 1  # pragma: no cover

    # ---- parameter counting (for MODEL_FLOPS = 6·N·D) ----------------------
    def param_counts(self) -> Dict[str, float]:
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        H, KV, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * H * dh + 2 * D * KV * dh + H * dh * D  # wq wk wv wo
        if self.qk_norm:
            attn += 2 * dh
        mlp = 3 * D * F  # SwiGLU gate/up/down
        ssm_p = 0.0
        if self.ssm is not None:
            s = self.ssm
            din, G, S, Hs = s.d_inner(D), s.n_groups, s.d_state, s.n_heads(D)
            in_proj = D * (2 * din + 2 * G * S + Hs)
            conv = s.d_conv * (din + 2 * G * S)
            if self.ssm_conv_bias:
                conv += din + 2 * G * S
            ssm_p = in_proj + conv + 3 * Hs + din + din * D  # +A,D,dt_bias,norm,out
        moe_p = 0.0
        if self.moe is not None:
            m = self.moe
            shared = 3 * D * self.shared_expert_ff
            moe_p = (D * self.n_routed + m.n_experts * 3 * D * m.d_ff_expert
                     + shared)
            # a token's experts: k of those routed, of which the held share
            # is computed here
            routed_a = m.top_k * 3 * D * m.d_ff_expert
            if self.n_routed != m.n_experts:
                routed_a = routed_a * m.n_experts / self.n_routed
        total = 0.0
        active = 0.0
        for kind in self.layer_kinds():
            mixer, ff = kind.split("+")
            mx = attn if mixer == "attn" else ssm_p
            if ff == "moe":
                m = self.moe
                ffp = moe_p
                ffa = D * self.n_routed + routed_a + shared
            elif ff == "mlp":
                ffp = ffa = mlp
            else:
                ffp = ffa = 0.0
            total += mx + ffp + 2 * D
            active += mx + ffa + 2 * D
        emb = V * D
        unemb = 0 if self.tie_embeddings else V * D
        total += emb + unemb + D
        active += emb + unemb + D
        if self.enc_dec is not None:
            e = self.enc_dec
            enc_layer = attn + mlp + 2 * D
            cross = attn
            total += e.n_enc_layers * enc_layer + self.n_layers * (cross + D)
            active += e.n_enc_layers * enc_layer + self.n_layers * (cross + D)
        return {"total": total, "active": active}

    # ---- smoke-test reduction ----------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny config for 1-device CPU smoke tests."""
        pat, _ = self.scan_groups()
        n_layers = len(pat) * min(2, max(1, self.n_layers // len(pat)))
        kv = max(1, min(self.n_kv_heads, 2))
        nh = max(kv, min(self.n_heads, 4))
        nh = (nh // kv) * kv or kv
        repl = {
            "n_layers": n_layers,
            "d_model": 64,
            "n_heads": nh,
            "n_kv_heads": kv,
            "d_head": 16,
            "d_ff": 128 if self.d_ff > 0 else 0,  # keep attention-free blocks
            "vocab_size": 512,
        }
        if self.moe is not None:
            repl["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=64)
        if self.ssm is not None:
            repl["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk_size=32)
        if self.enc_dec is not None:
            repl["enc_dec"] = dataclasses.replace(self.enc_dec, n_enc_layers=2, enc_seq=16)
        if self.n_prefix_tokens:
            repl["n_prefix_tokens"] = 4
        return dataclasses.replace(self, **repl)


# ---------------------------------------------------------------------------
# Shapes (assigned)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def supports_shape(arch: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention (SSM/hybrid only)."""
    if shape.name == "long_500k" and arch.family not in ("ssm", "hybrid"):
        return False, "full-attention arch: 512k dense-KV decode is quadratic — skipped (DESIGN §4)"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_ARCH_MODULES = [
    "smollm_135m", "qwen3_1p7b", "yi_6b", "qwen3_14b", "olmoe_1b_7b",
    "granite_moe_1b_a400m", "jamba_v0_1_52b", "whisper_medium",
    "internvl2_76b", "mamba2_1p3b", "granite_4_0_h_small",
]

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    key = name.replace("_", "-")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    for mod in _ARCH_MODULES:
        importlib.import_module(f"{__name__}.{mod}")
