"""The run-health watchdog (``ewdml_tpu/obs/health.py``): NaN, loss spike,
gradient explosion and stall as events.

Each anomaly becomes a ``health/<kind>`` trace instant, a
``health.<kind>`` counter in the registry the caller passes in, and a line
of ``health.jsonl`` (fsync'd per line; a torn last line is skipped when
read). Under ``--health abort`` the observing thread raises
:class:`HealthAbort`, which the entry points turn into the exit status
:data:`HEALTH_EXIT_CODE`; the experiments runner journals that status as a
retryable cell event.

Checks, all on the host and O(1) an observation:

- **nan**: the loss (or gradient norm) is not finite;
- **spike**: the loss's z-score against a streaming EMA mean and variance
  exceeds ``spike_z`` after ``warmup`` observations;
- **grad_norm**: the gradient norm exceeds ``grad_factor`` times its EMA
  after warm-up;
- **stall**: no observation or heartbeat within ``stall_deadline_s`` on the
  monotonic clock, checked by a daemon thread that retires while the
  watchdog is idle.

One event is emitted per episode: a run that stays at NaN latches, and a
healthy observation of the same signal re-arms the latch. The sync
``train/loop.Trainer`` observes the fenced window loss and
``parallel/ps.ParameterServer`` every push's loss it keeps. ``--health
off`` constructs nothing.

In abort mode a stall exits the process with ``os._exit`` after flushing
(the run's own threads are stuck).
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
from typing import Optional

from ewdml_tpu_torch.obs import clock
from ewdml_tpu_torch.obs import trace as otrace
from ewdml_tpu_torch.obs.registry import MetricsRegistry

logger = logging.getLogger("ewdml_tpu_torch.health")

#: Exit status of a run the watchdog aborted: distinct from the straggler
#: kill (77) and the injected crash (13), so a supervisor journals it as a
#: retryable health event, not a code bug.
HEALTH_EXIT_CODE = 76

MODES = ("off", "warn", "abort")

KINDS = ("nan", "spike", "grad_norm", "stall")


class HealthAbort(RuntimeError):
    """The watchdog's abort verdict (``--health abort``)."""

    def __init__(self, kind: str, step, detail: str):
        super().__init__(f"health abort [{kind}] at step {step}: {detail}")
        self.kind = kind
        self.step = step
        self.detail = detail


def read_events(path: str) -> list:
    """The events of a ``health.jsonl``; a torn line is skipped."""
    if not path or not os.path.isfile(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # the torn tail of a killed writer
    return out


class HealthWatchdog:
    """One per process role; its state sits behind one lock."""

    def __init__(self, mode: str, role: str = "", path: Optional[str] = None,
                 *, spike_z: float = 8.0, ema_alpha: float = 0.1,
                 warmup: int = 5, grad_factor: float = 100.0,
                 stall_deadline_s: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None, on_abort=None):
        if mode not in MODES:
            raise ValueError(f"--health must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.role = role
        self.path = path
        self.spike_z = float(spike_z)
        self.ema_alpha = float(ema_alpha)
        self.warmup = int(warmup)
        self.grad_factor = float(grad_factor)
        #: Called with the abort event in place of the raise: the TCP
        #: server's verdict stops its accept loop rather than unwinding a
        #: handler thread mid-reply (``parallel/ps_net.py``).
        self.on_abort = on_abort
        #: The counters' registry (a private one when none is passed in).
        self.registry = registry if registry is not None else MetricsRegistry()
        # The first abort verdict (written once, by the thread that trips
        # it; read without the lock, one observation late at worst).
        self.aborted: Optional[dict] = None  # ewdml: atomic
        self.events_emitted = 0  # ewdml: guarded-by[_lock]
        self._lock = threading.Lock()
        self._loss_mean = None   # ewdml: guarded-by[_lock]
        self._loss_var = 0.0     # ewdml: guarded-by[_lock]
        self._loss_n = 0         # ewdml: guarded-by[_lock]
        self._grad_mean = None   # ewdml: guarded-by[_lock]
        self._grad_n = 0         # ewdml: guarded-by[_lock]
        self._last_beat = clock.monotonic()  # ewdml: guarded-by[_lock]
        self._stalled = False    # ewdml: guarded-by[_lock]
        self._idle = False       # ewdml: guarded-by[_lock]
        # Episode latches: one event per episode of a signal, re-armed by
        # a healthy observation of it.
        self._latched = set()    # ewdml: guarded-by[_lock]
        self._counters = {k: self.registry.counter(f"health.{k}")
                          for k in KINDS}
        self._stop = threading.Event()
        self._stall_thread = None  # ewdml: guarded-by[_lock]
        self.stall_deadline_s = (float(stall_deadline_s)
                                 if mode != "off" and stall_deadline_s
                                 else None)
        if self.stall_deadline_s:
            self._spawn_stall_thread()

    # -- observations ------------------------------------------------------
    def heartbeat(self, step=None) -> None:
        """Progress: resets the stall deadline."""
        with self._lock:
            self._last_beat = clock.monotonic()
            self._stalled = False

    def set_idle(self, idle: bool = True) -> None:
        """Suspend (or resume) stall detection: no step progress is
        expected between ``train()`` calls. The detector thread retires
        while idle; resuming starts a fresh deadline."""
        with self._lock:
            self._idle = bool(idle)
            self._last_beat = clock.monotonic()
            self._stalled = False
        if not idle and self.stall_deadline_s:
            self._spawn_stall_thread()

    def _spawn_stall_thread(self) -> None:
        with self._lock:
            if self._stall_thread is not None or self._stop.is_set():
                return
            self._stall_thread = t = threading.Thread(
                target=self._stall_loop, name="ewdml-health-stall",
                daemon=True)
        t.start()

    def observe_loss(self, step, loss) -> None:
        """One loss observation (the fenced window mean in the trainer, a
        push's loss on the server); a heartbeat too."""
        if self.mode == "off":
            return
        loss = float(loss)
        if not math.isfinite(loss):
            self.heartbeat(step)
            with self._lock:
                first = "loss_nan" not in self._latched
                self._latched.add("loss_nan")
            if first:
                self._emit("nan", step, loss, f"non-finite loss {loss!r}")
            return
        with self._lock:
            self._last_beat = clock.monotonic()
            self._stalled = False
            self._latched.discard("loss_nan")
            mean, var, n = self._loss_mean, self._loss_var, self._loss_n
            z = None
            if n >= self.warmup and mean is not None:
                # A deviation floor relative to the mean (and an absolute
                # one): a constant loss history drives the variance to 0,
                # and a float-level tick is noise, not a spike.
                denom = max(math.sqrt(var), 0.01 * abs(mean), 1e-4)
                z = abs(loss - mean) / denom
            a = self.ema_alpha
            if mean is None:
                self._loss_mean, self._loss_var = loss, 0.0
            else:
                d = loss - mean
                self._loss_mean = mean + a * d
                self._loss_var = (1 - a) * (var + a * d * d)
            self._loss_n = n + 1
            spiking = z is not None and z > self.spike_z
            first = spiking and "spike" not in self._latched
            if spiking:
                self._latched.add("spike")
            else:
                self._latched.discard("spike")
        if first:
            self._emit("spike", step, loss,
                       f"loss {loss:.6g} is {z:.1f} sigma above the EMA "
                       f"(mean {mean:.6g}, threshold {self.spike_z})")

    def observe_grad_norm(self, step, norm) -> None:
        """The global gradient norm, where the caller has one on the
        host."""
        if self.mode == "off":
            return
        norm = float(norm)
        if not math.isfinite(norm):
            self.heartbeat(step)
            with self._lock:
                first = "grad_nan" not in self._latched
                self._latched.add("grad_nan")
            if first:
                self._emit("nan", step, norm,
                           f"non-finite gradient norm {norm!r}")
            return
        with self._lock:
            self._last_beat = clock.monotonic()
            self._latched.discard("grad_nan")
            mean, n = self._grad_mean, self._grad_n
            exploded = (n >= self.warmup and mean is not None and mean > 0
                        and norm > self.grad_factor * mean)
            first = exploded and "grad_norm" not in self._latched
            if exploded:
                self._latched.add("grad_norm")
            else:
                self._latched.discard("grad_norm")
            a = self.ema_alpha
            self._grad_mean = norm if mean is None else mean + a * (norm - mean)
            self._grad_n = n + 1
        if first:
            self._emit("grad_norm", step, norm,
                       f"gradient norm {norm:.6g} > {self.grad_factor:g}x "
                       f"EMA {mean:.6g}")

    # -- stall detection ---------------------------------------------------
    def _stall_loop(self) -> None:
        period = max(0.01, self.stall_deadline_s / 4.0)
        while not self._stop.wait(period):
            with self._lock:
                if self._idle:
                    self._stall_thread = None  # set_idle(False) respawns
                    return
                gap = clock.monotonic() - self._last_beat
                due = gap > self.stall_deadline_s and not self._stalled
                if due:
                    self._stalled = True  # one event per stall episode
            if due:
                self._emit("stall", None, round(gap, 3),
                           f"no step progress for {gap:.1f}s "
                           f"(deadline {self.stall_deadline_s:g}s)",
                           from_stall_thread=True)

    # -- emission ----------------------------------------------------------
    def _emit(self, kind: str, step, value, detail: str,
              from_stall_thread: bool = False) -> None:
        if isinstance(value, float) and not math.isfinite(value):
            value = repr(value)  # strict JSON: "nan" / "inf"
        event = {"ts": round(clock.wall_ns() / 1e9, 3), "kind": kind,
                 "role": self.role, "step": step, "value": value,
                 "detail": detail, "mode": self.mode}
        with self._lock:
            self.events_emitted += 1
        self._counters[kind].inc()
        # ewdml: allow[trace-name] -- bounded: `kind` is always one of the
        # closed KINDS tuple above (every _emit caller passes a literal
        # from it), so the instant-name set is finite by construction.
        otrace.instant(f"health/{kind}", step=step, value=value,
                       role=self.role)
        logger.warning("health[%s] %s: %s", self.role, kind, detail)
        if self.path:
            try:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                with open(self.path, "a") as f:
                    f.write(json.dumps(event) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            except OSError as e:  # never kill a healthy run over a write
                logger.warning("health event not persisted: %s", e)
        if self.mode != "abort":
            return
        with self._lock:
            if self.aborted is None:
                self.aborted = event
        otrace.flush()
        if self.on_abort is not None:
            self.on_abort(event)
            return
        if from_stall_thread:
            # The stuck thread cannot be unwound from here: exit with the
            # contract's status (the trace and health.jsonl are flushed).
            logger.error("health abort (stall): exiting %d", HEALTH_EXIT_CODE)
            os._exit(HEALTH_EXIT_CODE)
        raise HealthAbort(kind, step, detail)

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._stall_thread
        if t is not None:
            t.join(timeout=2)


def make_watchdog(cfg, role: str, stall_deadline_s: Optional[float] = None,
                  registry: Optional[MetricsRegistry] = None, on_abort=None
                  ) -> Optional[HealthWatchdog]:
    """The watchdog of a config, writing ``<train_dir>/health.jsonl``;
    None under ``--health off``."""
    if getattr(cfg, "health", "off") == "off":
        return None
    path = None
    if getattr(cfg, "train_dir", None):
        path = os.path.join(cfg.train_dir, "health.jsonl")
    return HealthWatchdog(cfg.health, role=role, path=path,
                          stall_deadline_s=stall_deadline_s,
                          registry=registry, on_abort=on_abort)
