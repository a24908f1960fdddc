"""Per-run perf ledger: the program's op mix, cost and memory, captured from
the calls themselves (the port's counterpart of
``gigapath_tpu/obs/ledger.py``).

The JAX package reads a traced program's jaxpr and XLA's cost and memory
analysis of its compiled executable. Eager PyTorch has neither, so a
profile here is taken on one real call of the function:

- the **fingerprint** counts the aten ops the call dispatches, the autograd
  backward's included, under a ``TorchDispatchMode``
  (``{"eqns_total", "quant", "mask", "primitives", "kernels"}``; an entry
  keeps it under the JAX schema's ``jaxpr`` key, so ``jaxpr`` holds the
  dispatched-op histogram here). The hand-written kernels stay opaque, as
  ``pallas_call`` bodies do in a jaxpr: what a kernel wrapper runs inside
  itself (its plain version on the CPU, its checks and allocations on the
  card) is not counted, and each call counts as one launch in the
  ``kernels`` column (``gigapath_tpu_torch/ops/common.py:kernel_wrapper``).
  For the same model and shapes the fingerprint is the same on the CPU and
  on the card;
- the **cost** adds ``torch.utils.flop_counter.FlopCounterMode``'s count of
  the aten products to each kernel's declared operations (the work its
  masks admit); ``bytes_accessed`` sums the bytes each counted op and
  kernel reads and writes (views move none). Both are the same on the CPU
  and on the card;
- the **memory** of a call on the card comes from the caching allocator
  around that call: ``argument_bytes`` (the tensor leaves of the
  arguments, with the parameters and buffers of a module argument or of
  the module ``fn`` is, or is a bound method of), ``output_bytes``, the
  peak allocated above the start less the outputs as ``temp_bytes``, and
  ``peak_bytes`` = arguments + temporaries + outputs, the JAX definition;
  ``donated_bytes`` is 0. On the CPU, which keeps no such account,
  ``temp_bytes`` and ``peak_bytes`` are None. To measure its call, a full
  profile resets the allocator's peak counters, after folding the run's
  peaks into :func:`peak_bytes`, which the heartbeat's watermarks and a
  caller's own peak window (:func:`reset_peaks`) read instead.

Running a function again would repeat its side effects (an optimizer step),
so a profile never reruns anything: :class:`CompileWatchdog.wrap
<gigapath_tpu_torch.obs.watchdog.CompileWatchdog>` and ``watchdog.profile``
take it on a key's first call itself (:meth:`PerfLedger.call_for_key`),
and the serving stack's graph cache on each key's warm-up forward
(:meth:`PerfLedger.run_profiled`, then :meth:`PerfLedger.adopt_compiled`).
The standalone :func:`capture_profile` and :meth:`PerfLedger.capture` run
``fn`` once.

Entries are keyed ``name|shape-signature`` in one canonical ledger JSON
next to the run log, with the JAX entry schema (``sig``, ``jaxpr``,
``cost``, ``memory``, ``compile_error``), so the stdlib-only
``scripts/ledger_diff.py`` diffs two of the port's ledgers. The first
signature per name gets a full profile, later ones the fingerprint only
(``capture_full`` overrides), or the signature alone
(:meth:`PerfLedger.sign`) where a caller sees a new key nearly every call
and the counting would cost each one (the ``--no-buckets`` inference
path). ``GIGAPATH_OBS=0``: :func:`get_ledger` returns a
:class:`NullLedger` (no events, no counting, no file).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

LEDGER_SCHEMA_VERSION = 1

# Columns every fingerprint reports (0 when absent): the glue ops (the
# counterparts of transpose, slice, broadcast_in_dim and reshape; under
# inference_mode the composite reshape reaches the counter undecomposed), the
# hand-written kernels' launches (the pallas_call column), and the
# sequence-parallel collectives: the gather route's all_gather and the
# ring's all_to_all exchange. Other ops appear under their own names.
FINGERPRINT_COLUMNS = (
    "transpose", "permute", "slice", "expand", "view", "reshape", "kernels", "all_gather", "all_to_all",
)

# c10d ops under the collective's column name
_COLLECTIVES = {
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather", "alltoall_base_": "all_to_all",
    "alltoall_": "all_to_all", "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "reduce_scatter_": "reduce_scatter", "_reduce_scatter_base_": "reduce_scatter",
    "broadcast_": "broadcast", "send": "send", "recv_": "recv",
}


# ---------------------------------------------------------------------------
# the op counter
# ---------------------------------------------------------------------------


def _finite(value) -> Optional[float]:
    """float(value) if finite, else None: a NaN must never reach a ledger
    (it serializes as a non-RFC token and blinds ledger_diff)."""
    try:
        f = float(value)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


def tensor_leaves(tree) -> List:
    """The tensors among the leaves of a nested list/tuple/dict."""
    import torch
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _is_low_precision(t) -> bool:
    name = str(t.dtype)
    return name == "torch.int8" or name.startswith("torch.float8")


def _is_square_mask(t) -> bool:
    import torch

    shape = tuple(t.shape)
    return t.dtype == torch.bool and len(shape) >= 2 and shape[-1] == shape[-2] and shape[-1] > 1


def _op_name(func) -> str:
    packet = func._overloadpacket.__name__
    namespace = getattr(func, "namespace", "aten")
    if namespace == "aten":
        return packet
    if namespace == "c10d" and packet in _COLLECTIVES:
        return _COLLECTIVES[packet]
    return f"{namespace}.{packet}"


def op_counter(full: bool, full_len: Optional[int] = None):
    """A new dispatch-mode op counter (open it with ``with``): with
    ``full`` it also counts bytes and the kernels' declared work, with
    ``full_len`` it lists every tensor carrying that axis."""
    return _counter_class()(full, full_len)


def _counter_class():
    """The counter's class, defined at first use: torch is imported inside
    the functions that need it."""
    global _OpCounter
    if _OpCounter is not None:
        return _OpCounter
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCounter(TorchDispatchMode):
        """Counts the aten ops dispatched while it is open (and, in a full
        profile, the bytes they move); the kernel wrappers report their
        launches, operations and bytes through :meth:`kernel_call`."""

        def __init__(self, full: bool, full_len: Optional[int] = None):
            super().__init__()
            self.full = full
            # with full_len: every op or kernel tensor carrying that axis
            self.full_len = full_len
            self.full_length: List[str] = []
            self.counts: Dict[str, int] = {}
            self.kernels: Dict[str, int] = {}
            self.quant = 0
            self.mask = 0
            self.op_bytes = 0.0
            self.kernel_flops = 0.0
            self.kernel_bytes = 0.0
            self.cost_errors: List[str] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = _op_name(func)
            self.counts[name] = self.counts.get(name, 0) + 1
            ins, outs = tensor_leaves((args, kwargs)), tensor_leaves(out)
            if any(_is_low_precision(t) for t in ins + outs):
                self.quant += 1
            if any(_is_square_mask(t) for t in outs):
                self.mask += 1
            if self.full and not func.is_view:
                self.op_bytes += sum(t.numel() * t.element_size() for t in ins + outs)
            self._watch(name, ins + outs)
            return out

        def _watch(self, name: str, tensors) -> None:
            if self.full_len is not None:
                self.full_length.extend(f"{name}: {tuple(t.shape)}" for t in tensors
                                        if self.full_len in tuple(t.shape))

        def kernel_call(self, name, cost, fn, args, kwargs):
            from torch.utils._python_dispatch import _disable_current_modes

            with _disable_current_modes():
                out = fn(*args, **kwargs)
                if self.full:
                    try:
                        flops, nbytes = cost(*args, **kwargs)
                        self.kernel_flops += float(flops)
                        self.kernel_bytes += float(nbytes)
                    except Exception as e:  # a profile must never take a run down
                        self.cost_errors.append(f"{name}: {type(e).__name__}: {e}")
            self._watch(name, tensor_leaves((args, kwargs, out)))
            # one launch a call (ops/common.py:kernel_wrapper)
            self.kernels[name] = self.kernels.get(name, 0) + 1
            self.counts["kernels"] = self.counts.get("kernels", 0) + 1
            return out

        def fingerprint(self) -> Dict[str, Any]:
            counts = dict(self.counts)
            for col in FINGERPRINT_COLUMNS:
                counts.setdefault(col, 0)
            return {
                "eqns_total": int(sum(counts.values())),
                "quant": int(self.quant),
                "mask": int(self.mask),
                "primitives": {k: int(v) for k, v in sorted(counts.items())},
                "kernels": {k: int(v) for k, v in sorted(self.kernels.items())},
            }

    _OpCounter = OpCounter
    return OpCounter


_OpCounter = None


# ---------------------------------------------------------------------------
# one profiled call
# ---------------------------------------------------------------------------


def _bytes_of(tensors) -> float:
    seen, total = set(), 0.0
    for t in tensors:
        key = (t.device, t.data_ptr(), t.numel() * t.element_size())
        if key not in seen:
            seen.add(key)
            total += key[2]
    return total


def _argument_tensors(fn, args: tuple, kwargs: dict) -> List:
    """The tensor leaves of the arguments, with the parameters and buffers of
    each module among them and of the module ``fn`` is or is bound to."""
    from torch import nn

    leaves = []
    owner = fn if isinstance(fn, nn.Module) else getattr(fn, "__self__", None)
    modules = [owner] if isinstance(owner, nn.Module) else []
    for value in list(args) + list(kwargs.values()):
        if isinstance(value, nn.Module):
            modules.append(value)
        else:
            leaves.extend(tensor_leaves(value))
    for module in modules:
        leaves.extend(module.parameters())
        leaves.extend(module.buffers())
    return leaves


class ProfiledCall:
    """What one full profile measured: the port's stand-in for a compiled
    executable in :func:`cost_analysis_of` / :func:`memory_analysis_of`.
    ``flops`` / ``bytes_accessed`` as counted; ``memory`` the call's
    argument, output and (on the card) peak-above-start bytes."""

    def __init__(self, flops, bytes_accessed, argument_bytes, output_bytes, peak_above_start):
        self.flops = flops
        self.bytes_accessed = bytes_accessed
        self.argument_bytes = argument_bytes
        self.output_bytes = output_bytes
        self.peak_above_start = peak_above_start


def cost_analysis_of(call: ProfiledCall) -> Dict[str, Optional[float]]:
    """``{"flops", "bytes_accessed"}`` of a profiled call; a field the
    profile could not count is None."""
    return {"flops": _finite(call.flops), "bytes_accessed": _finite(call.bytes_accessed)}


def memory_analysis_of(call: ProfiledCall) -> Dict[str, Optional[float]]:
    """Argument/output/temp/donated bytes and ``peak_bytes`` = arguments +
    temporaries + outputs (nothing is donated in eager PyTorch). The
    temporaries are the peak allocated above the call's start less its
    outputs; where the device keeps no allocator account (the CPU) they,
    and the peak, are None."""
    arg, out = _finite(call.argument_bytes), _finite(call.output_bytes)
    above = _finite(call.peak_above_start)
    tmp = peak = None
    if None not in (arg, out, above):
        tmp = max(above - out, 0.0)
        peak = arg + tmp + out
    return {"argument_bytes": arg, "output_bytes": out, "temp_bytes": tmp,
            "donated_bytes": 0.0, "peak_bytes": peak}


# The card's allocator peaks that a profile's reset would drop, per device
# index: a full profile folds them in here before it resets the counters,
# so a reader of the run's peak (:func:`peak_bytes`: the heartbeat's
# watermarks, a caller timing a whole run) still sees them.
_FOLDED_PEAKS: Dict[int, Dict[str, int]] = {}


def _device_index(device) -> int:
    import torch

    if device is None:
        return torch.cuda.current_device()
    if isinstance(device, int):
        return device
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def _peaks_now(index: int) -> Dict[str, int]:
    import torch

    stats = torch.cuda.memory_stats(index)
    folded = _FOLDED_PEAKS.get(index, {})
    return {kind: max(int(stats.get(f"{kind}_bytes.all.peak", 0)), folded.get(kind, 0))
            for kind in ("allocated", "reserved")}


def reset_peaks(device=None) -> None:
    """Open a peak window on the card: reset the allocator's peak counters
    of ``device`` (default: the current one) and forget the peaks that
    profiles folded in."""
    import torch

    index = _device_index(device)
    _FOLDED_PEAKS.pop(index, None)
    torch.cuda.reset_peak_memory_stats(index)


def peak_bytes(device=None) -> Dict[str, int]:
    """``{"allocated", "reserved"}``: the card's peak bytes since the last
    :func:`reset_peaks` (or the process start), through any full profile
    taken meanwhile, which resets the allocator's counters to measure its
    own call."""
    return _peaks_now(_device_index(device))


def _reset_for_profile(device) -> None:
    """Reset the allocator's peak counters of ``device`` for one profiled
    call, the run's peaks folded in first (:func:`peak_bytes`)."""
    import torch

    index = _device_index(device)
    _FOLDED_PEAKS[index] = _peaks_now(index)
    torch.cuda.reset_peak_memory_stats(index)


def _cuda_device(tensors):
    for t in tensors:
        if t.is_cuda:
            return t.device
    return None


def profile_call(fn, *args, full: bool = True, **kwargs) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args, **kwargs)`` once under the op counter and return
    ``(its output, its profile)``: the shape signature and the fingerprint
    always; with ``full`` also the cost (the flop counter on) and the
    memory (the card's allocator around the call). An exception of ``fn``
    propagates: the call is not repeated."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    counter = op_counter(full)
    device, arg_bytes = None, None
    if full:
        arg_tensors = _argument_tensors(fn, args, kwargs)
        arg_bytes = _bytes_of(arg_tensors)
        device = _cuda_device(arg_tensors)
    flop_mode = FlopCounterMode(display=False) if full else None
    start = 0
    if device is not None:
        torch.cuda.synchronize(device)
        _reset_for_profile(device)
        start = torch.cuda.memory_allocated(device)
    with flop_mode if flop_mode is not None else contextlib.nullcontext(), counter:
        out = fn(*args, **kwargs)
    profile: Dict[str, Any] = {"sig": shape_signature(args, kwargs), "jaxpr": counter.fingerprint()}
    if full:
        above = None
        if device is not None:
            torch.cuda.synchronize(device)
            above = torch.cuda.max_memory_allocated(device) - start
        ok = not counter.cost_errors
        call = ProfiledCall(
            flops=flop_mode.get_total_flops() + counter.kernel_flops if ok else None,
            bytes_accessed=counter.op_bytes + counter.kernel_bytes if ok else None,
            argument_bytes=arg_bytes, output_bytes=_bytes_of(tensor_leaves(out)), peak_above_start=above,
        )
        profile["cost"] = cost_analysis_of(call)
        profile["memory"] = memory_analysis_of(call)
        if counter.cost_errors:  # a kernel's declared work could not be counted
            profile["compile_error"] = "; ".join(counter.cost_errors)
    return out, profile


def capture_profile(fn, *args, full: bool = True, **kwargs) -> Dict[str, Any]:
    """One profile of ``fn(*args, **kwargs)``, taken by running it once
    (:func:`profile_call`): call it where running ``fn`` is what the caller
    wants done anyway, or on a function without side effects."""
    return profile_call(fn, *args, full=full, **kwargs)[1]


def op_fingerprint(fn, *args, **kwargs) -> Dict[str, Any]:
    """The dispatched-op fingerprint of one call of ``fn`` (run once): the
    counterpart of the JAX package's ``jaxpr_fingerprint``."""
    return profile_call(fn, *args, full=False, **kwargs)[1]["jaxpr"]


def compiled_flops(fn, *args) -> Optional[float]:
    """Operations of one call of ``fn(*args)`` (run once): the aten
    products plus the kernels' declared operations."""
    try:
        cost = capture_profile(fn, *args)["cost"]
    except Exception:
        return None
    return None if cost is None else cost["flops"]


def compiled_memory(fn, *args) -> Optional[Dict[str, Optional[float]]]:
    """temp/argument/output bytes of one call of ``fn(*args)`` (run once);
    temp is None off the card."""
    try:
        mem = capture_profile(fn, *args)["memory"]
    except Exception:
        return None
    return None if mem is None else {
        "temp_bytes": mem["temp_bytes"],
        "argument_bytes": mem["argument_bytes"],
        "output_bytes": mem["output_bytes"],
    }


# ---------------------------------------------------------------------------
# shape signatures
# ---------------------------------------------------------------------------


def _tree_size(value: Any) -> int:
    """Leaf count of a nested dict/list/tuple tree."""
    if isinstance(value, dict):
        return sum(_tree_size(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(_tree_size(v) for v in value)
    return 1


def _dtype_name(dtype) -> str:
    """``torch.float32`` -> ``float32`` (numpy dtypes print bare already),
    so the port's signatures read as the JAX package's."""
    return str(dtype).replace("torch.", "")


def shape_signature(args: tuple, kwargs: dict) -> str:
    """Static shape/dtype signature over tensor-like arguments
    (``float32[4,16,1536]``); a dict argument is summarised by its leaf
    count, other values are skipped."""
    parts: List[str] = []

    def leaf_sig(prefix: str, value: Any) -> None:
        shape = getattr(value, "shape", None)
        if shape is not None and hasattr(value, "dtype"):
            parts.append(f"{prefix}{_dtype_name(value.dtype)}[{','.join(map(str, shape))}]")
            return
        if isinstance(value, dict):
            parts.append(f"{prefix}tree{{{_tree_size(value)}}}")

    for a in args:
        leaf_sig("", a)
    for name in sorted(kwargs):
        leaf_sig(f"{name}=", kwargs[name])
    return ";".join(parts)


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


class NullLedger:
    """``GIGAPATH_OBS=0`` twin: records nothing, creates nothing; the calls
    it is handed run as they are."""

    path: Optional[str] = None

    def capture(self, name: str, fn, *args, **kwargs):
        return None

    capture_full = capture_fingerprint = capture

    def capture_for_key(self, name: str, key, fn, *args, **kwargs):
        return None

    def call_for_key(self, name: str, key, fn, *args, **kwargs):
        return fn(*args, **kwargs)

    def sign(self, name: str, key, *args, **kwargs):
        return None

    def has_full(self, name: str) -> bool:
        return False

    def run_profiled(self, name: str, fn, *args, **kwargs):
        return fn(*args, **kwargs), None

    def adopt_compiled(self, name: str, key, compiled: dict, *args, profile=None, **kwargs):
        return None

    def write(self, path: Optional[str] = None):
        return None

    @property
    def entries(self) -> Dict[str, dict]:
        return {}


class PerfLedger(NullLedger):
    """Folds a run's profiles into one canonical ledger JSON.

    Entries are keyed ``name|shape-signature`` and written sorted with a
    fixed field order, so two ledgers of the same code and shapes compare
    byte for byte. With ``autowrite`` the file is rewritten after every
    entry (the artifact exists the moment the run dies); without it, only
    by an explicit :meth:`write`.
    """

    def __init__(self, runlog=None, path: Optional[str] = None,
                 meta: Optional[dict] = None, autowrite: bool = True):
        self.runlog = runlog
        if path is None and runlog is not None and getattr(runlog, "path", None):
            base = os.path.dirname(os.path.abspath(runlog.path))
            path = os.path.join(base, f"{runlog.run_id}.ledger.json")
        self.path = path
        self.autowrite = autowrite
        self._entries: Dict[str, dict] = {}
        self._full_named: set = set()  # names that already got a full profile
        self.meta = dict(meta or {})

    @property
    def entries(self) -> Dict[str, dict]:
        return self._entries

    def capture(self, name: str, fn, *args, **kwargs) -> Optional[dict]:
        """Profile one call of ``fn`` (run once) under ``name`` unless this
        (name, signature) is already ledgered. Full for the first signature
        per name, fingerprint-only afterwards. Returns the entry (or the
        existing one), None when the call failed."""
        return self._capture(name, fn, args, kwargs, full=name not in self._full_named)

    def capture_full(self, name: str, fn, *args, **kwargs) -> Optional[dict]:
        """A full profile whatever the policy; it upgrades a
        fingerprint-only entry of the same signature."""
        return self._capture(name, fn, args, kwargs, full=True)

    def capture_fingerprint(self, name: str, fn, *args, **kwargs) -> Optional[dict]:
        """The fingerprint only (no flop counting, no allocator reset)."""
        return self._capture(name, fn, args, kwargs, full=False)

    def capture_for_key(self, name: str, key, fn, *args, **kwargs) -> Optional[dict]:
        """Like :meth:`capture`, tagging the entry and its event with the
        watchdog's key so compile and compile_profile events join."""
        from gigapath_tpu_torch.obs.runlog import _key_str

        return self._capture(name, fn, args, kwargs, full=name not in self._full_named,
                             extra={"key": _key_str(key)})

    def call_for_key(self, name: str, key, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` once and return its output; when
        this (name, signature) is new, the call itself is profiled (full
        for the first signature per name) and ledgered under ``key``. An
        exception of ``fn`` is filed as a failed profile and re-raised."""
        from gigapath_tpu_torch.obs.runlog import _key_str

        sig = shape_signature(args, kwargs)
        if f"{name}|{sig}" in self._entries:
            return fn(*args, **kwargs)
        try:
            out, profile = profile_call(fn, *args, full=name not in self._full_named, **kwargs)
        except Exception as e:
            self._failed(name, sig, e)
            raise
        self._add(name, profile, {"key": _key_str(key)})
        return out

    def sign(self, name: str, key, *args, **kwargs) -> Optional[dict]:
        """Ledger this (name, signature) by its shape signature alone,
        tagged with ``key``, running nothing (a key whose profile would
        cost more than its ledger line is worth). Dedups like a capture."""
        from gigapath_tpu_torch.obs.runlog import _key_str

        sig = shape_signature(args, kwargs)
        existing = self._entries.get(f"{name}|{sig}")
        if existing is not None:
            return existing
        return self._add(name, {"sig": sig}, {"key": _key_str(key)})

    def has_full(self, name: str) -> bool:
        """Whether ``name`` already has a full profile in this ledger."""
        return name in self._full_named

    def run_profiled(self, name: str, fn, *args, **kwargs):
        """``(fn(*args, **kwargs), its full profile)``, ``fn`` run once and
        nothing ledgered yet: the graph cache profiles a key's warm-up
        forward this way and hands the profile to :meth:`adopt_compiled`."""
        return profile_call(fn, *args, full=True, **kwargs)

    def adopt_compiled(self, name: str, key, compiled: dict, *args, profile=None,
                       **kwargs) -> Optional[dict]:
        """Ledger one captured graph: ``compiled`` holds its ``capture_s``,
        ``pool_bytes`` and ``launches`` (kernel name -> launches the
        capture recorded), ``args`` are the static input tensors (the
        signature) and ``profile`` the warm-up forward's
        (:meth:`run_profiled`), whose fingerprint, cost and memory join the
        entry. A second adoption of the same (name, signature) replaces the
        first."""
        from gigapath_tpu_torch.obs.runlog import _key_str

        sig = shape_signature(args, kwargs)
        self._entries.pop(f"{name}|{sig}", None)
        measured = {k: v for k, v in (profile or {}).items() if k in ("jaxpr", "cost", "memory")}
        return self._add(name, {"sig": sig, **measured}, {"key": _key_str(key), "graph": dict(compiled)})

    def _capture(self, name, fn, args, kwargs, *, full, extra: Optional[dict] = None) -> Optional[dict]:
        sig = shape_signature(args, kwargs)
        existing = self._entries.get(f"{name}|{sig}")
        if existing is not None and (not full or "cost" in existing or "compile_error" in existing):
            # a full request upgrades a fingerprint-only entry; anything
            # else dedups
            return existing
        try:
            profile = capture_profile(fn, *args, full=full, **kwargs)
        except Exception as e:
            self._failed(name, sig, e)
            return None
        return self._add(name, profile, extra or {})

    def _failed(self, name: str, sig: str, error: BaseException) -> None:
        if self.runlog is not None:
            self.runlog.event("compile_profile", name=name, sig=sig,
                              error=f"{type(error).__name__}: {error}")

    def _add(self, name: str, profile: dict, extra: dict) -> dict:
        if "cost" in profile and "compile_error" not in profile:
            self._full_named.add(name)
        entry = {"name": name, **extra, **profile}
        self._entries[f"{name}|{profile['sig']}"] = entry
        if self.runlog is not None:
            self.runlog.event("compile_profile", **entry)
        if self.autowrite:
            try:
                self.write()
            except Exception as e:  # the artifact must never take a run down
                if self.runlog is not None:
                    self.runlog.error("ledger.write", e)
        return entry

    def as_dict(self) -> dict:
        doc = {"v": LEDGER_SCHEMA_VERSION}
        doc.update(self.meta)
        if self.runlog is not None and getattr(self.runlog, "run_id", None):
            doc.setdefault("run", self.runlog.run_id)
        doc["entries"] = {k: self._entries[k] for k in sorted(self._entries)}
        return doc

    def write(self, path: Optional[str] = None) -> Optional[str]:
        path = path or self.path
        if path is None:
            return None
        write_ledger(self.as_dict(), path)
        return path


def write_ledger(doc: dict, path: str) -> str:
    """Canonical serialization: sorted keys, indent 1, trailing newline;
    ``allow_nan=False`` refuses a NaN loudly."""
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True, allow_nan=False)
        f.write("\n")
    return path


def get_ledger(runlog, path: Optional[str] = None, meta: Optional[dict] = None):
    """Ledger for a run: a real :class:`PerfLedger` when the runlog
    records to a file, a :class:`NullLedger` under ``GIGAPATH_OBS=0``."""
    if runlog is None or getattr(runlog, "path", None) is None:
        return NullLedger()
    return PerfLedger(runlog, path=path, meta=meta)
