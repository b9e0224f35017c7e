"""AST lints over ``src/repro_torch`` — the statically checkable half of
the port's parity discipline. Each rule keeps the JAX package's rule id,
which is also its waiver name (``common.parse_waivers``).

Rules:

oracle-purity
    Functions named ``*_oracle`` / ``*_host`` are the host plane of
    record: plain numpy, bit-reproducible, runnable without touching a
    device. Any reference to a ``torch`` alias inside one is a violation —
    a "host oracle" that silently routes through torch can drift with the
    device's rounding and stops being an oracle.

host-sync
    The port has no jit, so the JAX package's ``tracer-leak`` rule becomes
    "no host read on a kernel's launch path". In ``kernels/*.py`` the
    functions a CUDA launch runs through — each module's ``_kernel``, its
    public wrapper (the function named after the module) and the
    ``forward`` and ``backward`` of its ``torch.autograd.Function`` — may
    not call
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` or
    ``.synchronize()`` / ``torch.cuda.synchronize``, nor ``float()`` /
    ``int()`` / ``bool()`` on a tensor argument: each waits for the card.
    A parameter annotated with a host type (``int``, ``bool``,
    ``Optional[int]``, ...; anything whose annotation does not name
    ``Tensor``) is a plain Python value and may be converted freely, and
    ``.shape`` / ``.dtype`` / ``.ndim`` / ``.numel()`` / ``.stride()``
    (and the other metadata reads in ``_META``) read no device memory.
    Host helpers such as a ``cost`` formula are not launch paths.

nondeterminism
    Simulation code (core/, federated/, data/, kernels/, models/) draws all
    randomness from explicitly seeded generators — the host RNG stream of
    record — and never from wall clocks. The numpy rules are the JAX
    package's: module-singleton ``np.random.<draw>()`` calls, unseeded
    ``default_rng()`` / ``RandomState()``, ``time.time()`` and friends and
    ``datetime.now()`` are violations. Their torch twins: ``torch.rand`` /
    ``randn`` / ``randint`` / ``randperm`` / ``normal`` / ``bernoulli`` /
    ``multinomial`` and the in-place ``uniform_`` / ``normal_`` /
    ``random_`` / ``bernoulli_`` / ``exponential_`` without
    ``generator=`` (they draw from torch's global generator), and any
    ``torch.manual_seed`` / ``torch.seed`` / ``torch.cuda.manual_seed*``
    (which reseed it). The wall-clock half applies everywhere under
    ``src/repro_torch`` except ``obs/clock.py``, the port's one wall-clock
    site: a direct ``time.<clock>()`` call, and any import of ``time``,
    ``datetime`` or ``timeit``, elsewhere is a violation.

dtype-f64
    Device-side float64 belongs to the control plane only. The port has no
    x64 switch, so where the JAX package scopes float64 to
    ``with enable_x64():`` blocks the port names the control plane's
    modules (``F64_MODULES``); a ``torch.float64``, ``torch.double`` or
    ``.double()`` anywhere else in scope forks the f32 data plane. Host
    ``np.float64`` is not this rule's concern.

masked-mean-pin
    The masked-mean idiom must guard its denominator: ``torch.sum(x * m) /
    torch.sum(m)`` and its method form ``(x * m).sum() / m.sum()`` are
    violations — an empty mask yields NaN. Write ``... /
    m.sum().clamp_min(1.0)`` or ``torch.maximum(..., one)``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.check.common import (SRC_PREFIX, CheckContext, SourceFile,
                                      Violation, dotted_name, iter_functions)

# directories (relative to src/repro_torch) holding deterministic
# simulation code; launch/ + checkpoint/ + obs/ are host tooling where
# ad-hoc seeds are fine (the wall-clock half still applies there)
SIM_DIRS = ("core", "federated", "data", "kernels", "models")

# the float64 control plane (Eq. 1-3, Eq. 9, the schedules): the modules
# where the JAX package runs under ``enable_x64``
F64_MODULES = tuple(f"core/{m}.py" for m in (
    "wireless", "diversity", "reputation", "quality", "scheduler",
    "control", "population"))

# np.random constructors that are deterministic WHEN given a seed
_SEEDED_CTORS = {"default_rng", "RandomState", "SeedSequence", "PCG64",
                 "Philox", "SFC64", "MT19937"}
# "sleep" rides along: a sleep in simulation code means something is
# waiting on the wall clock — the async engine's event clock must advance
# ONLY through the Eq. 6/7 latency model on seeded draws
_CLOCK_FUNCS = {"time", "perf_counter", "monotonic", "time_ns",
                "perf_counter_ns", "monotonic_ns", "sleep"}
_CLOCK_MODULES = {"time", "datetime", "timeit"}
# torch draws from the global generator unless given ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial"}
_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_",
                  "exponential_"}
_TORCH_RESEEDS = {"manual_seed", "seed", "manual_seed_all"}
# host reads of a device value, as method calls
_HOST_READS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# tensor metadata: no device memory is read
_META = {"shape", "ndim", "dtype", "device", "numel", "stride", "size",
         "dim", "data_ptr", "element_size", "is_contiguous", "is_cuda",
         "requires_grad"}


def module_aliases(tree: ast.Module) -> Dict[str, str]:
    """Top-level import alias -> dotted module path (best effort)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _aliases_of(aliases: Dict[str, str], prefix: str) -> Set[str]:
    return {name for name, mod in aliases.items()
            if mod == prefix or mod.startswith(prefix + ".")}


def _violate(out: List[Violation], src: SourceFile, rule: str, line: int,
             msg: str) -> None:
    if not src.waived(rule, line):
        out.append(Violation(rule=rule, path=src.rel, line=line,
                             message=msg))


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


# --------------------------------------------------------------------- #
# oracle-purity
# --------------------------------------------------------------------- #
def lint_oracle_purity(src: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    torchish = _aliases_of(module_aliases(src.tree), "torch")
    if not torchish:
        return out
    for fn in iter_functions(src.tree):
        if not (fn.name.endswith("_oracle") or fn.name.endswith("_host")):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and node.id in torchish \
                    and isinstance(node.ctx, ast.Load):
                _violate(out, src, "oracle-purity", node.lineno,
                         f"host oracle `{fn.name}` references torch alias "
                         f"`{node.id}` — oracles are numpy-only "
                         "(rename the function if it is a device-side "
                         "twin, not a host oracle)")
    return out


# --------------------------------------------------------------------- #
# host-sync
# --------------------------------------------------------------------- #
def _is_autograd_function(cls: ast.ClassDef) -> bool:
    return any((dotted_name(b) or "").split(".")[-1] == "Function"
               for b in cls.bases)


def launch_functions(src: SourceFile) -> List[ast.FunctionDef]:
    """The functions of a kernel module that a CUDA launch runs through:
    ``_kernel``, the public wrapper named after the module, and every
    ``torch.autograd.Function``'s ``forward`` and ``backward`` (a
    backward launches the kernel again, as K5's does, or runs the plain
    VJP between the kernels of a train step, as K3's and K6's do)."""
    stem = src.rel.rsplit("/", 1)[-1][:-len(".py")]
    fns = [n for n in src.tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("_kernel", stem)]
    for cls in src.tree.body:
        if isinstance(cls, ast.ClassDef) and _is_autograd_function(cls):
            fns += [n for n in cls.body if isinstance(n, ast.FunctionDef)
                    and n.name in ("forward", "backward")]
    return fns


def _tensor_params(fn: ast.FunctionDef) -> Set[str]:
    """Parameters that may hold a tensor: unannotated, or annotated with a
    type that names ``Tensor``. ``forward``'s and ``backward``'s ``ctx`` is
    not one."""
    args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
    if fn.name in ("forward", "backward") and args:
        args = args[1:]
    return {a.arg for a in args
            if a.annotation is None or "Tensor" in ast.unparse(a.annotation)}


class _TensorNames(ast.NodeVisitor):
    """Bare Name loads in an expression, NOT behind a metadata access
    (``int(x.shape[0])`` and ``int(x.numel())`` read no device memory)."""

    def __init__(self):
        self.names: List[ast.Name] = []

    def visit_Attribute(self, node: ast.Attribute):
        if node.attr in _META:
            return
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        if isinstance(node.ctx, ast.Load):
            self.names.append(node)


def _tensor_name(expr: ast.AST, tensors: Set[str]) -> Optional[str]:
    v = _TensorNames()
    v.visit(expr)
    for n in v.names:
        if n.id in tensors:
            return n.id
    return None


def lint_host_sync(src: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    for fn in launch_functions(src):
        tensors = _tensor_params(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func) or ""
            if callee in ("float", "int", "bool"):
                hit = _tensor_name(node, tensors)
                if hit:
                    _violate(out, src, "host-sync", node.lineno,
                             f"`{callee}()` on tensor argument `{hit}` in "
                             f"`{fn.name}`, a launch path — it reads the "
                             "value back to the host and waits for the "
                             "card")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_READS:
                _violate(out, src, "host-sync", node.lineno,
                         f"`.{node.func.attr}()` in `{fn.name}`, a launch "
                         "path — a host sync; keep the value on the "
                         "device")
    return out


# --------------------------------------------------------------------- #
# nondeterminism
# --------------------------------------------------------------------- #
def _torch_draw(callee: str, call: ast.Call,
                torch_names: Set[str]) -> Optional[str]:
    """Why ``call`` draws from or reseeds torch's global generator, or
    None."""
    parts = callee.split(".")
    if parts[0] in torch_names:
        if len(parts) == 2 and parts[1] in _TORCH_DRAWS \
                and not _has_kw(call, "generator"):
            return (f"`{callee}(...)` without `generator=` draws from "
                    "torch's global generator — pass a seeded "
                    "torch.Generator")
        if parts[-1] in _TORCH_RESEEDS and (
                len(parts) == 2 or parts[1:-1] in (["cuda"], ["random"])):
            return (f"`{callee}(...)` reseeds torch's global generator — "
                    "seed a torch.Generator of your own")
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _INPLACE_DRAWS \
            and not _has_kw(call, "generator"):
        return (f"in-place `.{call.func.attr}(...)` without `generator=` "
                "draws from torch's global generator")
    return None


def lint_nondeterminism(src: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    aliases = module_aliases(src.tree)
    np_names = _aliases_of(aliases, "numpy")
    torch_names = {k for k, v in aliases.items() if v == "torch"}
    time_mods = _aliases_of(aliases, "time") & {
        k for k, v in aliases.items() if "." not in v}
    dt_mods = {k for k, v in aliases.items() if v == "datetime"}
    clock_funcs = {k for k, v in aliases.items()
                   if v in {f"time.{f}" for f in _CLOCK_FUNCS}}
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = dotted_name(node.func) or ""
        parts = callee.split(".")
        # np.random.* draws on the module singleton / unseeded ctors
        if len(parts) >= 3 and parts[0] in np_names \
                and parts[1] == "random":
            fname = parts[2]
            if fname not in _SEEDED_CTORS and fname != "Generator":
                _violate(out, src, "nondeterminism", node.lineno,
                         f"`{callee}(...)` draws from the global numpy "
                         "RNG — route through a seeded "
                         "np.random.Generator (the stream of record)")
            elif fname in _SEEDED_CTORS and not node.args:
                _violate(out, src, "nondeterminism", node.lineno,
                         f"unseeded `{callee}()` — pass an explicit "
                         "seed so the stream is reproducible")
        elif len(parts) == 2 and parts[0] in np_names \
                and parts[1] in ("default_rng", "RandomState") \
                and not node.args:
            _violate(out, src, "nondeterminism", node.lineno,
                     f"unseeded `{callee}()` — pass an explicit seed")
        # wall clocks
        elif (len(parts) == 2 and parts[0] in time_mods
                and parts[1] in _CLOCK_FUNCS) \
                or (len(parts) == 1 and parts[0] in clock_funcs):
            _violate(out, src, "nondeterminism", node.lineno,
                     f"wall clock `{callee}()` in simulation code — "
                     "results must be a function of config + seeds (the "
                     "async engine's event clock advances only through "
                     "the Eq. 6/7 latency model on seeded draws)")
        elif parts[-1] in ("now", "utcnow", "today") and (
                (len(parts) >= 2 and parts[0] in dt_mods)
                or (len(parts) >= 2
                    and aliases.get(parts[0], "") == "datetime.datetime")):
            _violate(out, src, "nondeterminism", node.lineno,
                     f"wall clock `{callee}()` in simulation code")
        else:
            why = _torch_draw(callee, node, torch_names)
            if why:
                _violate(out, src, "nondeterminism", node.lineno, why)
    return out


def lint_wall_clock(src: SourceFile) -> List[Violation]:
    """The wall-clock half of the nondeterminism rule, applied package-wide.

    Direct ``time.<clock>()`` calls (``time``, ``perf_counter``,
    ``monotonic``, the ``_ns`` variants, ``sleep``) anywhere under
    ``src/repro_torch`` are violations outside the one sanctioned site,
    ``obs/clock.py`` — host tooling that wants a timer routes through
    ``repro_torch.obs.clock.wall_clock`` so the telemetry plane owns every
    wall-clock read. Same rule id as the simulation lint, so
    ``# repro: allow(nondeterminism)`` waivers apply.
    """
    out: List[Violation] = []
    aliases = module_aliases(src.tree)
    time_mods = _aliases_of(aliases, "time") & {
        k for k, v in aliases.items() if "." not in v}
    clock_funcs = {k for k, v in aliases.items()
                   if v in {f"time.{f}" for f in _CLOCK_FUNCS}}
    if not time_mods and not clock_funcs:
        return out
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = dotted_name(node.func) or ""
        parts = callee.split(".")
        if (len(parts) == 2 and parts[0] in time_mods
                and parts[1] in _CLOCK_FUNCS) \
                or (len(parts) == 1 and parts[0] in clock_funcs):
            _violate(out, src, "nondeterminism", node.lineno,
                     f"wall clock `{callee}()` outside repro_torch.obs.clock "
                     "— route through `repro_torch.obs.clock.wall_clock`, "
                     "the port's only sanctioned wall-clock site")
    return out


def lint_clock_imports(src: SourceFile) -> List[Violation]:
    """An import of ``time``, ``datetime`` or ``timeit``, at any depth of
    the module: outside ``obs/clock.py`` the port has no use for a clock
    module (timers go through ``obs.clock.wall_clock``, stamps through
    ``obs.clock.utc_stamp``)."""
    out: List[Violation] = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            mods = [node.module]
        else:
            continue
        for m in mods:
            if m.split(".")[0] in _CLOCK_MODULES:
                _violate(out, src, "nondeterminism", node.lineno,
                         f"import of clock module `{m}` outside "
                         "repro_torch.obs.clock — route through "
                         "`repro_torch.obs.clock`")
    return out


# --------------------------------------------------------------------- #
# dtype-f64 / masked-mean-pin
# --------------------------------------------------------------------- #
def lint_dtype_f64(src: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    torch_names = {k for k, v in module_aliases(src.tree).items()
                   if v == "torch"}
    if not torch_names:
        return out
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Attribute) \
                and node.attr in ("float64", "double") \
                and isinstance(node.value, ast.Name) \
                and node.value.id in torch_names:
            what = f"`torch.{node.attr}`"
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "double" and not node.args:
            what = "`.double()`"
        else:
            continue
        _violate(out, src, "dtype-f64", node.lineno,
                 f"{what} outside the float64 control plane "
                 f"({', '.join(F64_MODULES)}) — device f64 is "
                 "control-plane only; the data plane is float32")
    return out


def lint_masked_mean(src: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    aliases = module_aliases(src.tree)
    torch_names = _aliases_of(aliases, "torch")
    if not torch_names:
        return out
    sums = {f"{a}.sum" for a in torch_names}

    def is_sum(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        if (dotted_name(node.func) or "") in sums:
            return True
        # the method form: <tensor expression>.sum(...), not a module's
        # own sum (``np.sum`` is the host's)
        return isinstance(node.func, ast.Attribute) \
            and node.func.attr == "sum" \
            and (dotted_name(node.func.value) or "") not in aliases

    for node in ast.walk(src.tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div) \
                and is_sum(node.left) and is_sum(node.right):
            _violate(out, src, "masked-mean-pin", node.lineno,
                     "unguarded masked mean `sum(..)/sum(..)` — pin the "
                     "denominator: `/ mask.sum().clamp_min(1.0)`")
    return out


# --------------------------------------------------------------------- #
# checker entry points (scope filtering + dispatch)
# --------------------------------------------------------------------- #
def _sub(src: SourceFile) -> Optional[str]:
    """The path under ``src/repro_torch/``, or None outside it."""
    if not src.rel.startswith(SRC_PREFIX):
        return None
    return src.rel[len(SRC_PREFIX):]


def _in_scope(src: SourceFile, dirs=SIM_DIRS) -> bool:
    sub = _sub(src)
    if sub is None:
        return False
    return sub.split("/")[0] in dirs or "/" not in sub


def check_oracle_purity(ctx: CheckContext) -> List[Violation]:
    return [v for s in ctx.sources if _in_scope(s, SIM_DIRS + (
        "launch", "sharding", "checkpoint", "optim", "configs"))
            for v in lint_oracle_purity(s)]


def check_host_sync(ctx: CheckContext) -> List[Violation]:
    return [v for s in ctx.sources
            if (_sub(s) or "").startswith("kernels/")
            for v in lint_host_sync(s)]


# the ONE file allowed to read the wall clock
_CLOCK_SITE = SRC_PREFIX + "obs/clock.py"


def check_nondeterminism(ctx: CheckContext) -> List[Violation]:
    out: List[Violation] = []
    for s in ctx.sources:
        if _sub(s) is None or s.rel == _CLOCK_SITE:
            continue
        if _in_scope(s):
            out.extend(lint_nondeterminism(s))
        else:
            out.extend(lint_wall_clock(s))
        out.extend(lint_clock_imports(s))
    return out


def check_dtype(ctx: CheckContext) -> List[Violation]:
    out = []
    for s in ctx.sources:
        if _in_scope(s, SIM_DIRS + ("optim", "configs")):
            if _sub(s) not in F64_MODULES:
                out.extend(lint_dtype_f64(s))
            out.extend(lint_masked_mean(s))
    return out
