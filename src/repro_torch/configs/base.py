"""FEEL round configuration: ``FeelConfig`` (the paper's Table I), the
dBm -> watt conversion its wireless constants share, ``ModelConfig`` (the
transformer of the LM task, ``lm_tiny``, and the configs of the big-model
zoo), its ``MoEConfig``, ``SSMConfig`` and ``MLAConfig`` sub-configs and
the zoo's ``InputShape`` values, and ``TrainConfig``, the optimizer and
training-loop hyper-parameters (the reference's, field for field).

``ModelConfig`` keeps the JAX package's field names and families:
``dense``, ``vlm`` (an early-fusion decoder over token ids, its image
frontend a stub), ``ssm`` (Mamba2), ``moe`` (attention with
mixture-of-experts MLPs; DeepSeek-V3 adds multi-head latent attention,
leading dense layers and a multi-token-prediction head), ``hybrid``
(Jamba: Mamba2 and attention layers interleaved, with experts) and
``audio`` (an encoder-decoder over precomputed frame embeddings, its
speech frontend a stub). A field that does not fit the family raises at
the config (``ValueError``, or ``TypeError`` for a sub-config of the wrong
type), where the reference accepts some silently and fails later at
init.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class FeelConfig:
    """Federated-edge-learning round configuration (the paper's Table I)."""
    n_ues: int = 50               # K
    n_malicious: int = 5
    # Candidate population size N (core/population.py); None pins N == K.
    population: Optional[int] = None
    rounds: int = 15              # t_max
    local_epochs: int = 3         # epsilon (paper leaves it unspecified)
    deadline_s: float = 300.0     # T
    bandwidth_hz: float = 1e6     # B
    model_size_bits: float = 100e3 * 8   # s = 100 Ko
    tx_power_dbm: float = -23.0   # P_k
    noise_dbm_hz: float = -174.0  # N0
    pathloss_exp: float = 3.76    # alpha (not given in paper; 3GPP UMa value)
    cell_side_m: float = 500.0
    min_selected: int = 5         # N in Algorithm 1
    # data-quality weights
    omega_rep: float = 0.5        # omega_1
    omega_div: float = 0.5        # omega_2
    gamma: Tuple[float, float, float] = (1 / 3, 1 / 3, 1 / 3)
    eta: float = 1.0              # reputation rate (paper: eta = 1)
    # beta_i are unspecified in the paper; weighted toward the server-side
    # test gap, the stronger poisoning signal (see EXPERIMENTS.md)
    beta1: float = 0.2            # weight of (acc_local - avg_acc)
    beta2: float = 0.8            # weight of (acc_local - acc_test)
    recovery_threshold: float = 0.5
    defense: str = "none"
    task: str = "mnist_mlp"
    # execution mode (federated/async_engine.py): "sync" runs lockstep
    # rounds, "async" the event-driven engine, which aggregates once
    # ``async_buffer`` uploads are buffered (None: the whole wave), also at
    # dispatch + ``async_deadline`` sim-seconds (None: no deadline), with
    # weights discounted by ``async_staleness`` ** age; every simulated
    # latency is scaled by ``async_latency_scale`` (0.0: the zero-latency
    # limit, where async reproduces sync exactly)
    mode: str = "sync"
    async_buffer: Optional[int] = None
    async_deadline: Optional[float] = None
    async_staleness: float = 0.5
    async_latency_scale: float = 1.0
    # AR(1)/Gauss-Markov small-scale fading correlation rho across
    # consecutive channel draws (core/wireless.py): 0.0 keeps the legacy
    # memoryless Rayleigh draw bit-for-bit; rho in (0, 1) gives each UE
    # persistent block-fading state with stationary |h|^2 ~ Exp(1).
    channel_corr: float = 0.0
    # client compute model (Eq. 6). zeta/f are unspecified in the paper;
    # calibrated so t_train spans [~1s, ~375s] against T=300s — large datasets
    # on slow UEs can blow the deadline, which is exactly the paper's
    # motivation for joint selection + bandwidth allocation.
    cycles_per_bit: float = 2e3   # zeta_k
    cpu_hz_min: float = 5e7       # f_k drawn uniformly in [min, max]
    cpu_hz_max: float = 5e8
    sample_bits: float = 28 * 28 * 8

    def __post_init__(self):
        if self.mode not in ("sync", "async"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.async_buffer is not None and self.async_buffer < 1:
            raise ValueError(f"async_buffer must be >= 1: "
                             f"{self.async_buffer}")
        if self.async_latency_scale < 0.0:
            raise ValueError(f"async_latency_scale must be >= 0: "
                             f"{self.async_latency_scale}")

    # Derived linear-scale wireless constants: Eq. 4/9 read the dBm -> watt
    # conversion from here, once.
    @property
    def n_population(self) -> int:
        """Candidate population size N (defaults to the budget K)."""
        n = self.population if self.population is not None else self.n_ues
        if n < self.n_ues:
            raise ValueError(f"population {n} smaller than the bandwidth "
                             f"budget K={self.n_ues}")
        return n

    @property
    def p_watt(self) -> float:
        """Uplink transmit power P_k in watts."""
        return dbm_to_watt(self.tx_power_dbm)

    @property
    def n0_watt_hz(self) -> float:
        """Noise power spectral density N0 in W/Hz."""
        return dbm_to_watt(self.noise_dbm_hz)


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0) / 1000.0


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (GShard-style capacity, sort-based dispatch)."""
    n_routed: int                 # routed experts
    top_k: int
    d_ff_expert: int              # hidden width of each routed expert
    n_shared: int = 0             # always-active shared experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    normalize_gates: bool = True  # renormalize top-k gate probs (DeepSeek style)
    # >1: group-local dispatch — tokens are grouped, sort/scatter happen
    # within a group, and the expert products take every group's rows at
    # once. 0/1 = single global dispatch (``models/moe.py``).
    dispatch_groups: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD sub-config."""
    d_state: int = 128            # N
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    n_groups: int = 1             # G (B/C groups)
    conv_kernel: int = 4
    chunk: int = 256              # SSD chunk length Q
    dt_min: float = 0.001
    dt_max: float = 0.1
    # dtype of the intra-chunk decay/score products (the reference's
    # materialised (Q x Q) tensors): "float32" or "bfloat16" (operands
    # rounded to bf16, sums in float32, the inter-chunk state float32)
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"ssm.compute_dtype must be 'float32' or "
                             f"'bfloat16', got {self.compute_dtype!r}")


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention sub-config [arXiv:2412.19437]."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    """A language model of the zoo: pre-norm layers of a mixer (GQA
    attention with RoPE and an optional sliding window, DeepSeek's
    multi-head latent attention, or a Mamba2 SSD block) and an MLP
    (SwiGLU, a mixture of experts, or none in the SSM family), stacked in
    ``n_blocks`` super-blocks of ``block_len`` layers after
    ``first_dense_layers`` unrolled attention + SwiGLU layers; with
    ``is_encoder_decoder``, an encoder of ``encoder_layers`` bidirectional
    layers before a decoder whose layers also cross-attend to it."""
    name: str
    family: str                   # dense | vlm | ssm | moe | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                     # dense-MLP hidden width (0 for pure SSM)
    vocab_size: int
    citation: str = ""

    head_dim: int = 0             # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    qk_norm: bool = False         # Chameleon-style query/key RMSNorm
    norm_eps: float = 1e-5
    # ``sliding_window`` applies to every shape (StarCoder2's own);
    # ``long_context_window`` only to sequences past 32,768 tokens on
    # otherwise full-attention archs (``transformer.decode_cache_len``)
    sliding_window: Optional[int] = None
    long_context_window: Optional[int] = None

    # MoE
    moe: Optional[MoEConfig] = None
    moe_layer_period: int = 1     # apply MoE every p-th layer (Jamba: 2)
    first_dense_layers: int = 0   # DeepSeek: first k layers use dense MLP
    # SSM / hybrid
    ssm: Optional[SSMConfig] = None
    attn_layer_period: int = 0    # hybrid: one attention layer per p layers
    attn_layer_offset: int = 4    # position of the attention layer in a block

    # Encoder-decoder (audio)
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    frontend: str = "none"        # none | audio | vlm (stubs: the inputs are
                                  # frame embeddings or token ids)
    # DeepSeek extras
    mla: Optional[MLAConfig] = None
    mtp: bool = False             # depth-1 multi-token-prediction head

    dtype: str = "bfloat16"
    block_len: int = 0            # 0 -> derived (the larger layer period)
    scan_unroll: int = 1

    # the frontend of each family
    _FAMILIES = {"dense": "none", "vlm": "vlm", "ssm": "none",
                 "moe": "none", "hybrid": "none", "audio": "audio"}

    def __post_init__(self):
        if self.family not in self._FAMILIES:
            raise ValueError(f"{self.name}: unknown family {self.family!r}; "
                             f"known: {sorted(self._FAMILIES)}")
        if self.frontend != self._FAMILIES[self.family]:
            raise ValueError(
                f"{self.name}: frontend={self.frontend!r} does not fit the "
                f"{self.family!r} family (its frontend is "
                f"{self._FAMILIES[self.family]!r})")
        self._check_sub_configs()
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.block_len == 0:
            p = max(1, self.attn_layer_period)
            if self.moe is not None:
                p = max(p, self.moe_layer_period)
            object.__setattr__(self, "block_len", p)
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads {self.n_heads} is not a "
                             f"multiple of n_kv_heads {self.n_kv_heads}")

    def _check_sub_configs(self):
        """The sub-configs, the layer periods, the leading dense layers
        and the encoder against the family."""
        for field, cls in (("moe", MoEConfig), ("ssm", SSMConfig),
                           ("mla", MLAConfig)):
            value = getattr(self, field)
            if value is not None and not isinstance(value, cls):
                raise TypeError(f"{self.name}: {field} must be a "
                                f"{cls.__name__}, got {type(value).__name__}")
        if self.family == "moe" and self.moe is None:
            raise ValueError(f"{self.name}: the moe family needs a MoEConfig")
        if self.family == "ssm" and self.ssm is None:
            raise ValueError(f"{self.name}: the ssm family needs an "
                             "SSMConfig")
        if self.family == "hybrid" and (self.ssm is None
                                        or not self.attn_layer_period):
            raise ValueError(f"{self.name}: the hybrid family needs an "
                             "SSMConfig and an attn_layer_period")
        if self.ssm is not None and self.family not in ("ssm", "hybrid"):
            raise ValueError(f"{self.name}: an SSMConfig belongs to the ssm "
                             f"or hybrid family, not {self.family!r}")
        if self.attn_layer_period and self.ssm is None:
            raise ValueError(f"{self.name}: attn_layer_period interleaves "
                             "attention with SSM layers and needs an "
                             "SSMConfig")
        if self.moe_layer_period > 1 and self.moe is None:
            raise ValueError(f"{self.name}: moe_layer_period "
                             f"{self.moe_layer_period} needs a MoEConfig")
        if self.is_encoder_decoder != (self.encoder_layers > 0):
            raise ValueError(
                f"{self.name}: is_encoder_decoder={self.is_encoder_decoder} "
                f"with encoder_layers={self.encoder_layers}; an "
                "encoder-decoder needs encoder layers, and only an "
                "encoder-decoder has them")
        if not 0 <= self.first_dense_layers < self.n_layers:
            raise ValueError(
                f"{self.name}: first_dense_layers={self.first_dense_layers} "
                f"must leave at least one of the {self.n_layers} layers to "
                "the scanned blocks")

    @property
    def scanned_layers(self) -> int:
        return self.n_layers - self.first_dense_layers

    @property
    def n_blocks(self) -> int:
        if self.scanned_layers % self.block_len:
            raise ValueError(f"{self.name}: {self.scanned_layers} layers not "
                             f"divisible by block_len {self.block_len}")
        return self.scanned_layers // self.block_len

    def layer_kind(self, idx_in_block: int) -> dict:
        """Sub-layer ``idx_in_block`` of a super-block: a Mamba2 mixer and
        no MLP in the SSM family; else attention (in a hybrid, only at
        ``attn_layer_offset`` mod ``attn_layer_period``, Mamba2 elsewhere)
        and a dense MLP, or a MoE every ``moe_layer_period``-th layer."""
        if self.family == "ssm":
            return {"mixer": "ssm", "mlp": "none"}
        mixer = "attn"
        if self.attn_layer_period:
            mixer = ("attn" if idx_in_block % self.attn_layer_period
                     == self.attn_layer_offset % self.attn_layer_period
                     else "ssm")
        mlp = "dense"
        if self.moe is not None and (idx_in_block % self.moe_layer_period
                                     == self.moe_layer_period - 1):
            mlp = "moe"
        return {"mixer": mixer, "mlp": mlp}

    def block_pattern(self) -> Tuple[dict, ...]:
        return tuple(self.layer_kind(i) for i in range(self.block_len))

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count, the reference's: embedding and head
        (untied); a layer's mixer, its MLP and two norm scales (counted
        whatever the MLP, as the reference does: an SSM layer has one);
        the leading dense layers; the encoder's layers and a
        cross-attention (and its norm) a decoder layer; the final norm;
        the MTP head. ``active_only`` counts a MoE layer's top-k routed
        experts instead of all of them."""
        d = self.d_model
        n = 2 * self.vocab_size * d
        for _ in range(self.n_blocks):
            for kind in self.block_pattern():
                n += self._mixer_params(kind["mixer"]) + 2 * d
                n += self._mlp_params(kind["mlp"], active_only)
        dense_layer = (self._mixer_params("attn")
                       + self._mlp_params("dense", active_only))
        n += self.first_dense_layers * (dense_layer + 2 * d)
        if self.is_encoder_decoder:
            n += self.encoder_layers * (dense_layer + 2 * d)
            n += self.n_layers * (self._mixer_params("attn") + d)
        n += d
        if self.mtp:       # a layer, the (2d, d) combine and three norms
            n += dense_layer + 2 * d * d + 3 * d
        return n

    def _mlp_params(self, kind: str, active_only: bool) -> int:
        if kind == "none":
            return 0
        if kind == "dense":
            return 3 * self.d_model * self.d_ff
        m = self.moe
        n_exp = (m.top_k if active_only else m.n_routed) + m.n_shared
        return n_exp * 3 * self.d_model * m.d_ff_expert + (
            self.d_model * m.n_routed)

    def _mixer_params(self, kind: str) -> int:
        d, hd = self.d_model, self.head_dim
        if kind == "attn" and self.mla is not None:
            m, h = self.mla, self.n_heads
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            return (d * m.q_lora_rank + m.q_lora_rank * h * qk_hd
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * h * (m.qk_nope_head_dim
                                            + m.v_head_dim)
                    + h * m.v_head_dim * d)
        if kind == "attn":
            return (d * self.n_heads * hd * 2
                    + 2 * d * self.n_kv_heads * hd)
        s = self.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        proj_in = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
        conv = (d_in + 2 * s.n_groups * s.d_state) * s.conv_kernel
        return proj_in + conv + d_in * d + nh * 3 + d_in


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / training-loop hyper-parameters."""
    optimizer: str = "adamw"      # sgd | momentum | adam | adamw | adafactor
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    remat: bool = True
