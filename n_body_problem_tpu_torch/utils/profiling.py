"""Profiling: ``torch.profiler`` traces, and the program's own spans and
counters on the trace's clock.

Counterpart of ``n_body_problem_tpu.utils.profiling``: the JAX package's
``jax.profiler`` trace becomes a ``torch.profiler`` trace of the host and,
on a GPU, the card, written as a Chrome trace (viewable in Perfetto or
``chrome://tracing``) by :func:`trace`, with the program's spans as a track
of their own.

**The program's spans.** Tracing is on exactly while a ``torch.profiler``
records (``TRACER.active()``); there is no other switch. While it is on, the
program keeps in memory:

- *host spans* (:class:`span`), each with its parent and its call (the
  root span it belongs to): ``sim.run`` (``Simulation.run``, attributes
  ``steps`` and ``solver``; the one span that also opens a
  ``record_function`` label, of its own name, which places the host spans on
  the trace's clock), each replay of a ``graphs.Program`` (on the CPU, each
  call) under the program's name (``treecode.resort``, ``treecode.build``,
  ``treecode.step``, ``step``, a frame's), ``graphs.capture`` (attribute
  ``programs``), and ``render`` with ``render.project``, ``render.scatter``
  and ``render.sprites``;
- *device phases* (:class:`Stamper`, names and parents in :data:`PHASES`)
  inside the hierarchical and flat treecode's programs: the build's
  ``build.levels``, ``build.open`` (``build.min_dist`` around each
  ``_min_tile_dist`` or ``_min_dist_open`` in it, the latter with the
  level's opening test) and ``build.lists`` (``build.select`` around
  each ``_top_k`` in it, the row selection); the step's
  ``force.operands``, ``force.near``, ``force.far``, ``force.vip`` and
  ``update``; the resort's ``resort.order`` (its keys and their sort,
  ``utils.morton.morton_order``, in every treecode path's resort). On the
  card a phase boundary is a one-thread kernel (``csrc/stamp.cu``,
  :data:`STAMP_KERNEL`) captured into the graph, which writes the phase and
  ``%globaltimer`` into a ring on the card at a cursor on the card, so that
  every replay leaves its own records and the host
  never waits; the host keeps the same count (each graph holds a known
  number of stamps). A graph is captured the same way whether tracing is on
  or off. Outside a graph, on the card, a boundary is launched only while
  tracing; on the CPU, where a program is called directly, it is a host
  record;
- *counters*: the build's last record carries the lists' work
  (:data:`COUNTERS`): near and far entries kept and shed by the capacities,
  the VIP bodies, and a step's near body pairs, far terms and VIP pairs on
  those lists; the resort's, ``tied_bodies`` (:data:`PHASE_COUNTERS`).

:func:`spans` resolves them, and :func:`work` sums the counters over the
steps that ran on each build's lists. The treecode's ``treecode.resort`` and
``treecode.build`` labels (``graphs.replay_chunks``,
``simulation.chunk_loop``) stay ``record_function`` labels; no span here
opens a label around a device launch except ``sim.run``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_NAME = "trace.json"
# The stamp kernel's name, as the device trace names its launches.
STAMP_KERNEL = "span_stamp_kernel"
RECORD = 12                # int64 fields a ring record (kFields in csrc/stamp.cu)
RING_RECORDS = 1 << 16     # records of one device's ring: 6 MiB
# Device phases and their parents. A phase that begins closes the open
# phases down to its parent: siblings need no end stamp between them.
PHASES = {
    "build.levels": None, "build.open": None, "build.min_dist": "build.open",
    "build.lists": None, "build.select": "build.lists",
    "force.operands": None, "force.near": None, "force.far": None, "force.vip": None,
    "update": None, "resort.order": None,
}
_NAMES = tuple(PHASES)
_CODE = {name: i for i, name in enumerate(_NAMES)}
_END_ALL = -1
# The build's counters, in the order of its record (``build.lists``' end).
COUNTERS = ("near_kept", "near_shed", "far_kept", "far_shed", "vip_bodies",
            "near_pairs", "far_terms", "vip_pairs")
# The counters of each phase whose end record carries some: the build's, and
# the resort's real bodies that share their 30-bit Morton key with the body
# before them (``utils.morton.tied_bodies``).
PHASE_COUNTERS = {"build.lists": COUNTERS, "resort.order": ("tied_bodies",)}


@dataclasses.dataclass
class Span:
    """One span of a traced window. Times are µs on the trace's clock when
    :func:`spans` was given the trace's events, else on the host's
    ``time.perf_counter`` (host) and the card's ``%globaltimer`` (device).
    ``device_start``/``device_end``: a phase's stamps, or a program replay's
    first and last (None where nothing was stamped; on the CPU the host
    records' times). ``call``: the id of the root span above it."""
    id: int
    name: str
    parent: int | None
    call: int
    host_start: float | None = None
    host_end: float | None = None
    device_start: float | None = None
    device_end: float | None = None
    counters: dict = dataclasses.field(default_factory=dict)
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def device_us(self) -> float | None:
        if self.device_start is None or self.device_end is None:
            return None
        return self.device_end - self.device_start


@dataclasses.dataclass
class _Host:
    """A host span as recorded: ``marks`` are the CPU's phase records
    (code, ns, counters), ``slots`` the card's ((ring, first, count))."""
    id: int
    name: str
    parent: int | None
    call: int
    start_ns: int
    end_ns: int | None = None
    attrs: dict = dataclasses.field(default_factory=dict)
    marks: list = dataclasses.field(default_factory=list)
    slots: list = dataclasses.field(default_factory=list)


class _Ring:
    """One CUDA device's ring of stamp records and its cursor, on the card.
    ``issued`` counts the stamps put on the device's streams (launched, or
    replayed inside a graph), which is what the cursor holds once they have
    run; ``captured`` the stamps captured into graphs."""

    def __init__(self, device: torch.device):
        self.buf = torch.zeros((RING_RECORDS, RECORD), dtype=torch.int64, device=device)
        self.cursor = torch.zeros((1,), dtype=torch.int64, device=device)
        self.issued = self.captured = 0
        self.first = self.last = 0     # the tracing window's stamps
        self.kept = None               # the ring as the window left it

    def launch(self, code: int, counters: torch.Tensor | None) -> None:
        from n_body_problem_tpu_torch.ops import cuda_build

        n = 0 if counters is None else counters.numel()
        ptr = None if counters is None else counters.data_ptr()
        stream = torch.cuda.current_stream(self.buf.device).cuda_stream
        cuda_build.check(cuda_build.load_library().nbody_span_stamp(
            self.buf.data_ptr(), self.cursor.data_ptr(), RING_RECORDS, code, ptr, n, stream),
            "span_stamp")


class Tracer:
    """The spans of the tracing window (the latest stretch in which a
    ``torch.profiler`` recorded) and the devices' rings. The module keeps
    one, :data:`TRACER`: the program's spans belong to the process, as the
    profiler does."""

    def __init__(self):
        self.on = False
        self.closing = False
        self.hosts: list[_Host] = []
        self.stack: list[_Host] = []
        self.rings: dict[torch.device, _Ring] = {}

    def active(self) -> bool:
        """Whether a ``torch.profiler`` records now. A change opens a new
        window (the last one's spans are dropped) or closes this one."""
        on = torch.autograd._profiler_enabled()
        if on is not self.on:
            self.on = on
            if on:
                self.hosts, self.stack, self.closing = [], [], False
                for r in self.rings.values():
                    r.first, r.kept = r.issued, None
            else:
                for r in self.rings.values():
                    r.last = r.issued
                self.closing = bool(self.rings)
        if self.closing:
            self._keep()
        return on

    def _keep(self) -> None:
        """Copy each ring as the window left it, before later replays
        overwrite it; deferred while a graph is being captured."""
        if torch.cuda.is_current_stream_capturing():
            return
        for r in self.rings.values():
            r.kept = r.buf.clone()
        self.closing = False

    def ring(self, device: torch.device) -> _Ring:
        """``device``'s ring, allocated on first request (outside any
        capture: ``graphs.tree_programs`` asks before the first)."""
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self.rings:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the span ring is allocated before a graph is captured")
            self.rings[device] = _Ring(device)
        return self.rings[device]

    def push(self, name: str, attrs: dict) -> _Host:
        parent = self.stack[-1] if self.stack else None
        rec = _Host(len(self.hosts), name, None if parent is None else parent.id,
                    len(self.hosts) if parent is None else parent.call, time.perf_counter_ns(),
                    attrs=attrs)
        self.hosts.append(rec)
        self.stack.append(rec)
        return rec

    def pop(self, rec: _Host) -> None:
        rec.end_ns = time.perf_counter_ns()
        if self.stack and self.stack[-1] is rec:
            self.stack.pop()

    def issue(self, ring: _Ring, count: int) -> None:
        """``count`` stamps put on the device (a replay's or one launch),
        given to the innermost open host span while tracing."""
        first = ring.issued
        ring.issued += count
        if self.on and self.stack:
            self.stack[-1].slots.append((ring, first, count))

    def mark(self, code: int, counters: torch.Tensor | None) -> None:
        """A phase boundary recorded on the host (the CPU's programs)."""
        if self.stack:
            self.stack[-1].marks.append(
                (code, time.perf_counter_ns(), [] if counters is None else counters.tolist()))

    # ------------------------------------------------------------ resolve
    def resolve(self, events=None) -> list[Span]:
        self.active()
        data = {}
        for dev, r in self.rings.items():
            torch.cuda.synchronize(dev)
            # Stamps the host did not count (a graph captured elsewhere)
            # would shift every slot: then the ring is not read.
            if int(r.cursor) == r.issued:
                data[id(r)] = ((r.buf if self.on or r.kept is None else r.kept).cpu().numpy(),
                               r.issued if self.on else r.last, r.first)
        host_off, dev_off = _offsets(self.hosts, data, events)
        out: list[Span] = []
        next_id = len(self.hosts)
        for h in self.hosts:
            host = Span(h.id, h.name, h.parent, h.call, h.start_ns / 1e3 + host_off,
                        None if h.end_ns is None else h.end_ns / 1e3 + host_off,
                        attrs=dict(h.attrs))
            out.append(host)
            recs = [(c, t / 1e3 + host_off, cnt) for c, t, cnt in h.marks]
            for ring, first, count in h.slots:
                if id(ring) not in data:
                    continue
                buf, last, lo = data[id(ring)]
                for seq in range(first, first + count):
                    if seq >= lo and last - seq <= RING_RECORDS:   # not yet overwritten
                        row = buf[seq % RING_RECORDS]
                        recs.append((int(row[0]), row[1] / 1e3 + dev_off,
                                     [int(v) for v in row[2:]]))
            children = _phases(recs, host, next_id)
            next_id += len(children)
            if recs:
                host.device_start, host.device_end = recs[0][1], recs[-1][1]
            out.extend(children)
        return out


def _phases(recs: list, host: Span, next_id: int) -> list[Span]:
    """The device phases of one host span's records, in their order."""
    out, stack = [], []
    for code, t, counters in recs:
        if code >= 0 and code % 2 == 0:      # a phase begins
            name = _NAMES[code // 2]
            while stack and stack[-1].name != PHASES[name]:
                stack.pop().device_end = t
            parent = stack[-1].id if stack else host.id
            s = Span(next_id + len(out), name, parent, host.call, device_start=t)
            out.append(s)
            stack.append(s)
            continue
        name = None if code == _END_ALL else _NAMES[code // 2]
        while stack:
            s = stack.pop()
            s.device_end = t
            if s.name == name:
                s.counters = (dict(zip(PHASE_COUNTERS.get(name, COUNTERS), counters))
                              if any(counters) else {})
                break
    return out


def _offsets(hosts: list[_Host], data: dict, events) -> tuple[float, float]:
    """(host, device) µs to add to the host's ``perf_counter`` and the
    card's ``%globaltimer`` to reach the trace's clock: the medians over
    ``sim.run``'s spans against its ``record_function`` labels (midpoints),
    and over the stamps against the stamp kernel's entries (matched in
    order). 0 for a clock that ``events`` cannot place."""
    if not events:
        return 0.0, 0.0
    labels = sorted((e["ts"] + e["dur"] / 2) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") == "sim.run"
                    and "dur" in e)
    runs = [(h.start_ns + h.end_ns) / 2e3 for h in hosts
            if h.name == "sim.run" and h.end_ns is not None]
    host_off = _median_offset(labels, runs)
    kernels = sorted((e["ts"] + e["dur"] / 2) for e in events
                     if e.get("cat") == "kernel" and STAMP_KERNEL in e.get("name", "")
                     and "dur" in e)
    stamps = sorted(buf[seq % RING_RECORDS, 1] / 1e3 for buf, last, lo in data.values()
                    for seq in range(max(lo, last - RING_RECORDS), last))
    dev_off = _median_offset(kernels, stamps)
    return host_off, dev_off


def _median_offset(ref: list[float], own: list[float]) -> float:
    """Median of ref - own over matched pairs: in order when the counts
    agree, else each own time against the ref time nearest it once shifted
    by the first pair's difference."""
    if not ref or not own:
        return 0.0
    if len(ref) == len(own):
        return statistics.median(r - o for r, o in zip(ref, own))
    ref_a, own_a = np.asarray(ref), np.asarray(own)
    if len(ref_a) == 1:
        return float(np.median(ref_a[0] - own_a))
    shifted = own_a + (ref_a[0] - own_a[0])
    i = np.clip(np.searchsorted(ref_a, shifted), 1, len(ref_a) - 1)
    near = np.where(np.abs(ref_a[i - 1] - shifted) <= np.abs(ref_a[i] - shifted), i - 1, i)
    return float(np.median(ref_a[near] - own_a))


TRACER = Tracer()


class span:
    """``with span(name, **attrs):`` a host span while tracing; one check
    of the profiler's state otherwise. ``label=True`` also opens a
    ``record_function`` label of the span's name (``sim.run`` alone: the
    anchor of the host spans on the trace's clock)."""

    __slots__ = ("name", "attrs", "label", "rec", "fn")

    def __init__(self, name: str, label: bool = False, **attrs):
        self.name, self.label, self.attrs = name, label, attrs
        self.rec = self.fn = None

    def __enter__(self):
        if TRACER.active():
            if self.label:
                self.fn = record_function(self.name)
                self.fn.__enter__()
            self.rec = TRACER.push(self.name, self.attrs)
        return self.rec

    def __exit__(self, *exc):
        if self.rec is not None:
            TRACER.pop(self.rec)
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


class Stamper:
    """The phase boundaries of one region of a program (:data:`PHASES`):
    ``begin(name)`` closes the open phases down to the phase's parent and
    opens it; ``end(name, counters)`` closes it (with its counters, an int64
    tensor of at most ``RECORD - 2`` values, which read as none where all
    are 0) and ``end()`` every open phase.
    ``live`` is False where nothing is recorded: compute counters only when
    it is True. Made by :func:`stamper`."""

    def __init__(self, device: torch.device | None, mode: str | None):
        self.device, self.mode = device, mode
        self.live = mode is not None

    def begin(self, name: str) -> None:
        if self.live:
            self._mark(2 * _CODE[name], None)

    def end(self, name: str | None = None, counters: torch.Tensor | None = None) -> None:
        if self.live:
            self._mark(_END_ALL if name is None else 2 * _CODE[name] + 1, counters)

    def _mark(self, code: int, counters: torch.Tensor | None) -> None:
        if counters is not None:
            counters = counters.to(torch.int64).contiguous()
        if self.mode == "host":
            TRACER.mark(code, counters)
            return
        ring = TRACER.ring(self.device)
        ring.launch(code, counters)
        if self.mode == "graph":
            ring.captured += 1
        else:
            TRACER.issue(ring, 1)


NO_STAMPS = Stamper(None, None)


def stamper(device: torch.device) -> Stamper:
    """The stamper of a region that runs on ``device``: stamp kernels while
    a CUDA graph is captured on a device with a ring (``graphs.StaticRun``
    counts them), whether tracing or not; while tracing, outside a graph, a
    kernel launched a boundary on the card and a host record on the CPU;
    :data:`NO_STAMPS` otherwise."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return Stamper(device, "graph") if device in TRACER.rings else NO_STAMPS
    if not TRACER.active():
        return NO_STAMPS
    return Stamper(device, "launch" if device.type == "cuda" else "host")


def spans(events=None) -> list[Span]:
    """The spans of the latest tracing window (the last time a
    ``torch.profiler`` recorded), the host's in the order they opened, each
    followed by the device phases it holds; on the card the rings are read
    after a synchronize. ``events``, the Chrome trace's events of that
    window (``json.load(...)["traceEvents"]``), puts every time on the
    trace's clock (:func:`_offsets`)."""
    return TRACER.resolve(events)


def work(found: list[Span]) -> dict:
    """The window's list work: each build's counters (its ``build.lists``
    phase) times the ``treecode.step`` spans that ran on its lists (those
    after it, up to the next build), summed; with ``steps`` (the steps
    after a counted build) and ``builds``."""
    out = dict.fromkeys(COUNTERS, 0)
    out.update(steps=0, builds=0)
    current = None
    for s in found:
        if s.name == "build.lists" and s.counters:
            current = s.counters
            out["builds"] += 1
        elif s.name == "treecode.step" and current is not None:
            out["steps"] += 1
            for k in COUNTERS:
                out[k] += current[k]
    return out


@contextlib.contextmanager
def trace(log_dir: str | pathlib.Path | None):
    """``with trace("out/profile"):`` writes ``out/profile/trace.json``,
    the program's spans in it as a track of their own (:func:`_span_track`);
    no-op when ``log_dir`` is None. The card's activity is traced when CUDA
    is available."""
    if log_dir is None:
        yield
        return
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = log_dir / TRACE_NAME
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    data["traceEvents"] += _span_track(spans(data["traceEvents"]), data["traceEvents"])
    path.write_text(json.dumps(data))


def _span_track(found: list[Span], events: list) -> list:
    """Chrome-trace events of ``found`` as a process of its own beside
    ``events``: the host spans on one thread, the device phases on another,
    with their ids, parents, counters and attributes as arguments."""
    if not found:
        return []
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    out = [{"ph": "M", "name": "process_name", "pid": pid, "args": {"name": "program spans"}},
           {"ph": "M", "name": "thread_name", "pid": pid, "tid": 0, "args": {"name": "host"}},
           {"ph": "M", "name": "thread_name", "pid": pid, "tid": 1, "args": {"name": "device"}}]
    for s in found:
        args = {"id": s.id, "parent": s.parent, "call": s.call, **s.counters, **s.attrs}
        if s.host_start is not None and s.host_end is not None:
            out.append({"ph": "X", "name": s.name, "pid": pid, "tid": 0, "ts": s.host_start,
                        "dur": s.host_end - s.host_start, "args": args})
        elif s.device_us is not None:
            out.append({"ph": "X", "name": s.name, "pid": pid, "tid": 1, "ts": s.device_start,
                        "dur": s.device_us, "args": args})
    return out
