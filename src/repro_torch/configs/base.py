"""Run configuration: the port's own copy of ``FederatedConfig``,
``FaultConfig``, ``ArchConfig``, ``ShapeConfig``, ``SHAPES`` and
``validate`` from ``src/repro/configs/base.py``, with the same fields,
defaults and validation.  The port keeps a copy instead of importing the
reference so that it runs where JAX is not installed.

Every field is the reference's contract.  ``popstore`` and
``popstore_min_clients`` are read only by the reference's launchers, which
the port does not have yet; rounds ignore them, as the reference's do.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class FaultConfig:
    """Deterministic client-fault schedule, pure in ``(seed, round, client)``.

    ``dropout``/``straggler`` silence a client for the round, ``delay``
    lands its uplink late (silence when the async engine is off),
    ``corrupt`` mangles the transmitted packet."""

    dropout: float = 0.0    # P(client never returns this round)
    straggler: float = 0.0  # P(client misses the round barrier)
    delay: float = 0.0      # P(uplink delayed s rounds; silence if async off)
    corrupt: float = 0.0    # P(transmitted uplink mangled on the wire)
    blowup: float = 1e6     # magnitude multiplier of the "blowup" corruption
    seed: int = 1234        # fault RNG seed, independent of the data/mask seeds
    delay_max: int = 4      # lateness s drawn uniformly from [1, delay_max]

    def __post_init__(self):
        for name in ("dropout", "straggler", "delay", "corrupt"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(
                    f"fault rate {name} must be in [0, 1], got {v}")
        if self.delay_max < 1:
            raise ValueError(
                f"delay_max must be a positive lateness bound, got "
                f"{self.delay_max}")

    @property
    def any(self) -> bool:
        return (self.dropout > 0 or self.straggler > 0 or self.delay > 0
                or self.corrupt > 0)

    @classmethod
    def parse(cls, spec: str) -> "FaultConfig":
        """Build from a CLI spec string, e.g. ``"dropout=0.1,corrupt=0.05,seed=7"``."""
        kwargs = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            key, _, val = item.partition("=")
            key = key.strip()
            if key not in cls.__dataclass_fields__:
                raise ValueError(
                    f"unknown fault field {key!r} (have "
                    f"{sorted(cls.__dataclass_fields__)})")
            kwargs[key] = int(val) if key in ("seed", "delay_max") else float(val)
        return cls(**kwargs)


@dataclass(frozen=True)
class FederatedConfig:
    """How the paper's centralised-network optimisers run.  Field meanings
    are documented at length in the reference (``src/repro/configs/base.py``);
    the short notes here name what each selects."""

    algorithm: str = "gpdmm"  # gpdmm | agpdmm | scaffold | fedavg | fedsplit
    inner_steps: int = 2  # K in the paper
    # float (one global stepsize) | "auto" (resolve host-side first) |
    # tuple (one stepsize per client row)
    eta: float | str | Tuple[float, ...] = 1e-2
    rho: Optional[float] = None  # None -> 1/(K * mean eta)
    layout: str = "client_axis"  # client_axis | fsdp
    num_clients: Optional[int] = None
    use_avg: bool = True  # GPDMM dual update: eq. (23) x_bar vs eq. (24) x_K
    fedsplit_init: str = "z"
    gamma: Optional[float] = None  # FedSplit prox weight; None -> 1/rho
    eta_g: float = 1.0  # SCAFFOLD server stepsize
    uplink_bits: Optional[int] = None  # EF21-quantised uplink; None = exact
    participation: float = 1.0  # fraction of clients active per round
    cohort: bool | str = "auto"  # cohort-sampled engine (participation < 1)
    cohort_tile: Optional[int] = None
    popstore: bool | str = "auto"  # host-resident population store
    popstore_min_clients: int = 65_536
    seed: int = 17  # participation RNG seed
    # flat client-state arena: True | False | "auto" (arena iff the packed
    # width reaches arena_min_width)
    use_arena: bool | str = "auto"
    arena_min_width: int = 1024
    rounds_per_call: int = 1
    topology: str = "star"  # star | ring | complete | torus | er[:p]
    graph_schedule: str = "color"  # color | sync
    variance_reduction: Optional[str] = None  # None | "svrg"
    faults: Optional[FaultConfig] = None
    screen: bool | str = "auto"  # uplink screening
    screen_mult: float = 100.0
    async_rounds: bool | str = "auto"  # bounded-staleness engine
    deadline: float = float("inf")
    max_staleness: int = 0
    stale_gamma: float = 0.5
    tol: float = 0.0  # residual-based early termination; 0 = off
    patience: int = 1

    def __post_init__(self):
        if self.inner_steps < 1:
            raise ValueError(
                f"inner_steps must be >= 1, got {self.inner_steps}")
        if isinstance(self.eta, str):
            if self.eta != "auto":
                raise ValueError(
                    f"eta must be a positive stepsize, a tuple of them, or "
                    f"'auto', got {self.eta!r}")
        elif isinstance(self.eta, tuple):
            if not self.eta or any(
                    not (isinstance(e, (int, float)) and e > 0.0)
                    for e in self.eta):
                raise ValueError(
                    f"eta tuple must hold one positive per-client stepsize "
                    f"per row, got {self.eta!r}")
        elif not (isinstance(self.eta, (int, float)) and self.eta > 0.0):
            raise ValueError(
                f"eta must be a positive stepsize, got {self.eta!r}")
        if self.rho is not None and not self.rho > 0.0:
            raise ValueError(
                f"rho must be a positive penalty (or None for the 1/(K*eta) "
                f"default), got {self.rho}")
        if not self.tol >= 0.0:
            raise ValueError(
                f"tol must be >= 0 (0 disables early termination), got "
                f"{self.tol}")
        if self.patience < 1:
            raise ValueError(
                f"patience must be >= 1 consecutive sub-tol rounds, got "
                f"{self.patience}")
        if not (0.0 < self.participation <= 1.0):
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}")
        if self.cohort not in (True, False, "auto"):
            raise ValueError(
                f"cohort must be True, False or 'auto', got {self.cohort!r}")
        if self.cohort_tile is not None and self.cohort_tile < 1:
            raise ValueError(
                f"cohort_tile must be a positive tile size or None, got "
                f"{self.cohort_tile}")
        if self.popstore not in (True, False, "auto"):
            raise ValueError(
                f"popstore must be True, False or 'auto', got "
                f"{self.popstore!r}")
        if self.popstore_min_clients < 1:
            raise ValueError(
                f"popstore_min_clients must be >= 1, got "
                f"{self.popstore_min_clients}")
        if self.screen not in (True, False, "auto"):
            raise ValueError(
                f"screen must be True, False or 'auto', got {self.screen!r}")
        if self.async_rounds not in (True, False, "auto"):
            raise ValueError(
                f"async_rounds must be True, False or 'auto', got "
                f"{self.async_rounds!r}")
        if not self.deadline > 0.0:
            raise ValueError(
                f"deadline must be a positive round count (inf = no "
                f"deadline), got {self.deadline}")
        if self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {self.max_staleness}")
        if not (0.0 < self.stale_gamma <= 1.0):
            raise ValueError(
                f"stale_gamma must be in (0, 1], got {self.stale_gamma}")
        if (self.cohort_tile is not None and self.num_clients is not None
                and self.participation < 1.0):
            # local import: core imports configs
            from repro_torch.core.tree_util import cohort_count
            mc = cohort_count(self.num_clients, self.participation)
            if self.cohort_tile < mc and mc % self.cohort_tile:
                raise ValueError(
                    f"cohort_tile={self.cohort_tile} does not divide the "
                    f"cohort size {mc} (= ceil(participation="
                    f"{self.participation} * num_clients={self.num_clients}))")


# ---------------------------------------------------------------------------
# Input shapes (assigned, public pool)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # None -> d_model // n_heads

    # Repeating block pattern.  Entries: "dense" (attn+mlp), "moe" (attn+moe),
    # "rwkv" (rwkv6 time-mix + channel-mix), "rec" (RG-LRU block + mlp),
    # "local" (local/sliding-window attn + mlp).
    block_pattern: Tuple[str, ...] = ("dense",)

    # --- attention ---
    attn_kind: str = "gqa"  # gqa | mla | none
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window size for "local" blocks /
    #                               sw-variant of dense archs (long_500k)

    # --- MLA (deepseek v2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None  # per-expert hidden; None -> d_ff
    first_dense_layers: int = 0  # leading dense layers (deepseek v2)
    moe_fused_dispatch: bool = False  # one dispatch for all top-k slots + a
    #   single bf16 expert-combine psum instead of k f32 ones (SSPerf H1)

    # --- norm / misc ---
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    tie_embeddings: bool = False
    act: str = "silu"  # silu (swiglu) | gelu (geglu)

    # --- recurrent ---
    rec_d_state: int = 0  # RG-LRU recurrent width (0 -> d_model)
    conv_width: int = 4  # temporal conv width in RG-LRU block
    wkv_head_dim: int = 64  # rwkv6 head size

    # --- modality frontends (STUBS: precomputed embeddings by input_specs) ---
    frontend: Optional[str] = None  # vision | audio | None
    n_prefix_tokens: int = 0  # image patches / audio frames per sample
    frontend_dim: int = 0  # ViT / codec feature dim
    n_codebooks: int = 1  # musicgen parallel codebooks

    # --- serving ---
    shard_cache_seq: bool = False  # SSPerf H2: shard the KV-cache seq dim over
    #   "model" when the head dim cannot (GQA kv < model axis, or MLA)
    subquadratic: bool = False  # eligible for long_500k as-is
    sw_variant_window: Optional[int] = None  # if set, long_500k runs with this
    #                                          sliding window (dense archs)

    # --- distribution ---
    fed: FederatedConfig = field(default_factory=FederatedConfig)
    remat: bool = True
    scan_layers: bool = True
    microbatch: Optional[int] = None  # split the per-client batch into this
    #   many grad-accumulation chunks inside each inner step (activation
    #   memory / microbatch, same FLOPs; see EXPERIMENTS.md SSPerf)
    dtype: str = "bfloat16"
    source: str = ""  # citation

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_units(self) -> int:
        return self.n_layers // self.pattern_len

    @property
    def tail_blocks(self) -> Tuple[str, ...]:
        """Blocks for layers beyond the last full pattern unit."""
        rem = self.n_layers % self.pattern_len
        return self.block_pattern[:rem]

    @property
    def supports_decode(self) -> bool:
        return True  # all assigned archs are decoder-style

    def supports_shape(self, shape: ShapeConfig) -> bool:
        if shape.name == "long_500k":
            return self.subquadratic or self.sw_variant_window is not None
        return True

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        pat = self.block_pattern
        # keep one full pattern unit (or 2 layers for singleton patterns)
        n_layers = max(2, len(pat))
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        # keep the GQA ratio flavour when possible
        if self.n_kv_heads < self.n_heads:
            n_kv = max(1, n_heads // max(1, self.n_heads // self.n_kv_heads))
        head_dim = d_model // n_heads
        return replace(
            self,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            moe_d_ff=None if self.moe_d_ff is None else min(self.moe_d_ff, 128),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            first_dense_layers=min(self.first_dense_layers, 1),
            kv_lora_rank=min(self.kv_lora_rank, 64),
            q_lora_rank=min(self.q_lora_rank, 64),
            rope_head_dim=min(self.rope_head_dim, 32) if self.kv_lora_rank else self.rope_head_dim,
            nope_head_dim=min(self.nope_head_dim, 32),
            v_head_dim=min(self.v_head_dim, 32),
            rec_d_state=min(self.rec_d_state, 256) if self.rec_d_state else 0,
            wkv_head_dim=min(self.wkv_head_dim, 32),
            window=min(self.window, 64) if self.window else None,
            sw_variant_window=min(self.sw_variant_window, 64) if self.sw_variant_window else None,
            n_prefix_tokens=min(self.n_prefix_tokens, 16) if self.n_prefix_tokens else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            dtype="float32",
            remat=False,
            scan_layers=True,
        )

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and memory napkin math)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        if self.n_codebooks > 1:
            total += (self.n_codebooks - 1) * 2 * v * d
        if self.frontend == "vision":
            total += self.frontend_dim * d + d * d  # 2-layer projector
        per_block: dict[str, int] = {}
        attn_p = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.attn_kind == "mla":
            qd = self.q_lora_rank or d
            attn_p = 0
            if self.q_lora_rank:
                attn_p += d * self.q_lora_rank
            attn_p += qd * self.n_heads * (self.nope_head_dim + self.rope_head_dim)
            attn_p += d * (self.kv_lora_rank + self.rope_head_dim)
            attn_p += self.kv_lora_rank * self.n_heads * (self.nope_head_dim + self.v_head_dim)
            attn_p += self.n_heads * self.v_head_dim * d
        mlp_p = 3 * d * self.d_ff
        per_block["dense"] = attn_p + mlp_p
        per_block["local"] = attn_p + mlp_p
        moe_ff = self.moe_d_ff or self.d_ff
        per_block["moe"] = (
            attn_p
            + self.n_experts * 3 * d * moe_ff
            + self.n_shared_experts * 3 * d * moe_ff
            + d * self.n_experts  # router
        )
        # rwkv6 block: r,k,v,g,w,o projections + channel mix
        per_block["rwkv"] = 6 * d * d + 3 * d * self.d_ff
        # rg-lru block: in/out proj x2 branches + conv + recurrent gates + mlp
        d_rnn = self.rec_d_state or d
        per_block["rec"] = 2 * d * d_rnn + d_rnn * d + self.conv_width * d_rnn + 2 * d_rnn * d_rnn // 8 + mlp_p
        for i in range(self.n_layers):
            blk = self.block_pattern[i % self.pattern_len]
            if blk in ("dense", "moe") and i < self.first_dense_layers:
                total += per_block["dense"]
            else:
                total += per_block[blk]
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_ff = self.moe_d_ff or self.d_ff
        n_moe_layers = sum(
            1
            for i in range(self.n_layers)
            if self.block_pattern[i % self.pattern_len] == "moe" and i >= self.first_dense_layers
        )
        inactive = n_moe_layers * (self.n_experts - self.top_k) * 3 * self.d_model * moe_ff
        return full - inactive


def validate(cfg: ArchConfig) -> None:
    assert cfg.n_heads % cfg.n_kv_heads == 0, (cfg.name, "GQA ratio")
    if cfg.family == "moe":
        assert cfg.n_experts > 0 and cfg.top_k > 0, cfg.name
    if cfg.attn_kind == "mla":
        assert cfg.kv_lora_rank > 0, cfg.name
    for b in cfg.block_pattern:
        assert b in ("dense", "moe", "rwkv", "rec", "local"), b
