"""FEEL round configuration: ``FeelConfig`` (the paper's Table I), the
dBm -> watt conversion its wireless constants share, ``ModelConfig`` (the
transformer of the LM task, ``lm_tiny``, and the decoder-only configs of
the big-model zoo), ``SSMConfig`` and the zoo's ``InputShape`` values.

``ModelConfig`` keeps the JAX package's field names. The port runs the
decoder-only families: ``dense``, ``vlm`` (an early-fusion decoder over
token ids, its image frontend a stub), ``ssm`` (Mamba2), ``moe``
(attention with mixture-of-experts MLPs, ``MoEConfig``) and ``hybrid``
(Jamba: Mamba2 and attention layers interleaved, with experts). The MLA,
encoder-decoder, multi-token prediction and leading-dense-layer fields
exist so that a config reads as the reference's, but setting any of them
raises ``NotImplementedError`` naming the slice of the port that brings
it. A sub-config that does not fit the family raises at the config
(``ValueError``, or ``TypeError`` for a sub-config of the wrong type),
where the reference accepts some silently and fails later at init.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class FeelConfig:
    """Federated-edge-learning round configuration (the paper's Table I)."""
    n_ues: int = 50               # K
    n_malicious: int = 5
    # Fields of the planes the port does not run yet (population, the
    # defense and LM task planes, async mode) are kept so that a config
    # matches the JAX package's field for field; the port's server raises
    # on any value it cannot run.
    # Candidate population size N; None pins N == K.
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

    # Derived linear-scale wireless constants: Eq. 4/9 read the dBm -> watt
    # conversion from here, once.
    @property
    def n_population(self) -> int:
        """Candidate population size N (defaults to the budget K)."""
        n = self.population if self.population is not None else self.n_ues
        assert n >= self.n_ues, (
            f"population {n} smaller than the bandwidth budget K="
            f"{self.n_ues}")
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
    # dtype of the reference's materialised intra-chunk decay/score
    # tensors; the port computes them in float32 and takes no other value
    compute_dtype: str = "float32"


_LATER = "a later slice of the port"


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-only language model: pre-norm layers of a mixer (GQA
    attention with RoPE and an optional sliding window, or a Mamba2 SSD
    block) and an MLP (SwiGLU, a mixture of experts, or none in the SSM
    family), stacked in ``n_blocks`` super-blocks of ``block_len``
    layers."""
    name: str
    family: str                   # dense | vlm | ssm | moe | hybrid
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

    # MoE; ``first_dense_layers`` is not ported (a non-default raises)
    moe: Optional[MoEConfig] = None
    moe_layer_period: int = 1     # apply MoE every p-th layer (Jamba: 2)
    first_dense_layers: int = 0
    # SSM / hybrid
    ssm: Optional[SSMConfig] = None
    attn_layer_period: int = 0    # hybrid: one attention layer per p layers
    attn_layer_offset: int = 4    # position of the attention layer in a block

    # planes of the zoo the port does not run yet (any non-default raises)
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    frontend: str = "none"        # none | vlm (a stub: inputs are token ids)
    mla: Optional[object] = None
    mtp: bool = False

    dtype: str = "bfloat16"
    block_len: int = 0            # 0 -> derived (the larger layer period)
    scan_unroll: int = 1

    # (field, default, the slice that brings it)
    _UNPORTED = (("first_dense_layers", 0,
                  _LATER + " (DeepSeek's MLA, MTP and leading dense "
                  "layers)"),
                 ("mla", None, _LATER + " (DeepSeek's MLA)"),
                 ("mtp", False, _LATER + " (DeepSeek's MTP head)"),
                 ("encoder_layers", 0, _LATER + " (the encoder-decoder)"),
                 ("is_encoder_decoder", False,
                  _LATER + " (the encoder-decoder)"))
    _FAMILIES = {"dense": "none", "vlm": "vlm", "ssm": "none",
                 "moe": "none", "hybrid": "none"}

    def __post_init__(self):
        if self.family not in self._FAMILIES:
            raise NotImplementedError(
                f"{self.name}: the {self.family!r} family is not ported; "
                f"it comes with {_LATER}")
        for field, default, slice_ in self._UNPORTED:
            if getattr(self, field) != default:
                raise NotImplementedError(
                    f"{self.name}: {field}={getattr(self, field)!r} is not "
                    f"ported; it comes with {slice_}")
        if self.frontend != self._FAMILIES[self.family]:
            raise NotImplementedError(
                f"{self.name}: frontend={self.frontend!r} with family "
                f"{self.family!r} is not ported (the audio frontend comes "
                f"with {_LATER}, the encoder-decoder)")
        self._check_sub_configs()
        if self.ssm is not None and self.ssm.compute_dtype != "float32":
            raise NotImplementedError(
                f"{self.name}: ssm.compute_dtype="
                f"{self.ssm.compute_dtype!r} is not ported; the SSD scan "
                f"computes in float32 until {_LATER} brings a lower "
                f"precision")
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
        """The MoE and SSM sub-configs and the layer periods against the
        family."""
        for field, cls in (("moe", MoEConfig), ("ssm", SSMConfig)):
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
        """Analytic parameter count, the reference's for the ported
        families: embedding and head (untied); a layer's mixer, its MLP and
        two norm scales (counted whatever the MLP, as the reference does:
        an SSM layer has one); the final norm. ``active_only`` counts a
        MoE layer's top-k routed experts instead of all of them."""
        n = 2 * self.vocab_size * self.d_model
        for _ in range(self.n_blocks):
            for kind in self.block_pattern():
                n += self._mixer_params(kind["mixer"]) + 2 * self.d_model
                n += self._mlp_params(kind["mlp"], active_only)
        return n + self.d_model

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
