"""threadcheck: test-only lock-witness sanitizer + interleaving harness
(the JAX package's ``monitor/threadcheck.py`` over the port's racelint).

The static half of the concurrency discipline lives in
``analysis/racelint.py``: every cross-thread-mutated attribute carries a
declared policy, and ``guarded-by`` accesses are verified *lexically*.
This module is the dynamic half — it turns those same declarations into
runtime assertions, so a guarded attribute touched without its lock
fails the touching test with a stack trace instead of corrupting state
silently.

Witness
-------
:func:`checked` builds a subclass of a production class whose
``guarded-by``-declared attributes (parsed by racelint's own
:func:`~cxxnet_tpu_torch.analysis.racelint.collect_policies`, so lint and
witness can never disagree about the attr→lock map) are replaced with
data descriptors.  After :func:`arm` is called on an instance, every
read or write of a guarded attribute asserts that one of its declaring
locks is held by the current thread, raising :class:`LockWitnessError`
otherwise.  Plain ``threading.Lock`` attributes are wrapped in
:class:`WitnessLock` at arm time for exact ownership tracking;
``Condition``/``RLock`` objects are queried through their ``_is_owned``.

``__slots__`` classes work: the subclass delegates storage to the
parent's slot member descriptors, and the subclass's fresh ``__dict__``
holds the witness bookkeeping.

Interleaving harness
--------------------
:func:`hook` is a no-op marker that race fixtures place between the
read and the write of a critical section; a test installs a callback
with :func:`set_hook` (usually a barrier wait) to force the exact
interleaving that loses an update — deterministically, not
stochastically.  :func:`stress` is the post-fix side: N threads hammer
a callable under a tiny ``sys.setswitchinterval`` so the fixed code can
demonstrate it no longer loses updates.

Test-only by design: nothing in the serving/checkpoint/io planes
imports this module; tests opt in per class.
"""

from __future__ import annotations

import inspect
import sys
import threading
from typing import Callable, Dict, Iterable, Optional, Tuple


class LockWitnessError(AssertionError):
    """A guarded-by-declared attribute was touched without its lock."""


class WitnessLock:
    """Owner-tracking wrapper over a ``threading.Lock``.

    Mutual exclusion is delegated to the wrapped lock (so other holders
    of the same inner lock object — e.g. a ``Condition`` built over it —
    still exclude correctly); ownership is recorded here so
    :func:`held_by_me` answers for the *current thread*, which a plain
    ``Lock.locked()`` cannot."""

    def __init__(self, inner: Optional[threading.Lock] = None):
        self._inner = inner if inner is not None else threading.Lock()
        self._owner: Optional[int] = None
        self.acquisitions = 0    # telemetry for tests

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self.acquisitions += 1
        return got

    def release(self) -> None:
        self._owner = None
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self) -> "WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


def _held(lock) -> bool:
    """Best-effort: does the CURRENT thread hold ``lock``?"""
    if isinstance(lock, WitnessLock):
        return lock.held_by_me()
    is_owned = getattr(lock, "_is_owned", None)  # RLock / Condition
    if is_owned is not None:
        try:
            return bool(is_owned())
        except Exception:  # noqa: BLE001 — witness must not crash code
            return False
    locked = getattr(lock, "locked", None)
    return bool(locked()) if locked is not None else False


class _WitnessAttr:
    """Data descriptor over one guarded attribute: storage delegates to
    the parent slot member (``__slots__`` classes) or the instance dict;
    every touch after :func:`arm` asserts a declaring lock is held."""

    def __init__(self, base: type, name: str, locks: Tuple[str, ...]):
        self._member = base.__dict__.get(name)   # slot member descriptor
        self._name = name
        self._locks = locks
        # value-storage key, distinct from the ``_threadcheck_armed``
        # flag namespace (a guarded attr named ``armed`` must not
        # collide with the witness's own arming bit)
        self._key = f"_threadcheck_value_{name}"

    def _check(self, obj, op: str) -> None:
        if not obj.__dict__.get("_threadcheck_armed", False):
            return   # construction / un-armed instance: no witness
        for lname in self._locks:
            lock = getattr(obj, lname, None)
            if lock is not None and _held(lock):
                return
        raise LockWitnessError(
            f"{type(obj).__name__}.{self._name}: {op} on thread "
            f"{threading.current_thread().name!r} without holding "
            f"{' or '.join('self.' + n for n in self._locks)} "
            f"(declared guarded-by; see racelint)")

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._check(obj, "read")
        if self._member is not None:
            return self._member.__get__(obj, objtype)
        try:
            return obj.__dict__[self._key]
        except KeyError:
            raise AttributeError(self._name) from None

    def __set__(self, obj, value) -> None:
        self._check(obj, "write")
        if self._member is not None:
            self._member.__set__(obj, value)
        else:
            obj.__dict__[self._key] = value


def guarded_attrs(cls: type) -> Dict[str, Tuple[str, ...]]:
    """{attr: (lock attr names, ...)} for one class, parsed from its
    source file's ``# racelint: guarded-by(...)`` annotations."""
    from ..analysis import racelint
    src = inspect.getsourcefile(cls)
    if src is None:
        return {}
    polmap = racelint.collect_policies(src).get(cls.__name__, {})
    out: Dict[str, Tuple[str, ...]] = {}
    for attr, pol in polmap.items():
        if pol.kind == "guarded-by":
            out[attr] = tuple(a[5:] for a in pol.args
                              if a.startswith("self."))
    return out


def checked(cls: type) -> type:
    """Subclass of ``cls`` with witness descriptors over every
    guarded-by-declared attribute.  Instances behave identically until
    :func:`arm` is called on them."""
    guarded = guarded_attrs(cls)
    ns: Dict[str, object] = {
        "_threadcheck_guarded": guarded,
        # subclass deliberately has no __slots__: its __dict__ carries
        # the witness bookkeeping even over a __slots__ parent
    }
    for attr, locks in guarded.items():
        ns[attr] = _WitnessAttr(cls, attr, locks)
    return type(f"Checked{cls.__name__}", (cls,), ns)


def arm(obj) -> None:
    """Start witnessing ``obj`` (an instance of a :func:`checked`
    subclass): wrap its plain-Lock lock attributes in
    :class:`WitnessLock` for exact ownership, then enable the
    assertions."""
    guarded = getattr(type(obj), "_threadcheck_guarded", None)
    if guarded is None:
        raise TypeError(
            f"{type(obj).__name__} is not a checked() subclass")
    for locks in guarded.values():
        for lname in locks:
            lock = getattr(obj, lname, None)
            if lock is None or isinstance(lock, WitnessLock):
                continue
            # only wrap bare Locks; Condition/RLock already track owners
            if type(lock) is type(threading.Lock()):
                setattr(obj, lname, WitnessLock(lock))
    obj.__dict__["_threadcheck_armed"] = True


def disarm(obj) -> None:
    obj.__dict__["_threadcheck_armed"] = False


# --------------------------------------------------------------------------
# interleaving harness

_hooks: Dict[str, Callable[[], None]] = {}
_hook_lock = threading.Lock()


def hook(name: str) -> None:
    """Interleaving marker: a no-op unless a test installed a callback
    under ``name``.  Race fixtures call this between the read and the
    write of their critical section so tests can force the losing
    schedule with a barrier instead of praying to the scheduler."""
    cb = _hooks.get(name)
    if cb is not None:
        cb()


def set_hook(name: str, cb: Callable[[], None]) -> None:
    with _hook_lock:
        _hooks[name] = cb


def clear_hooks() -> None:
    with _hook_lock:
        _hooks.clear()


def stress(fn: Callable[[int], None], *, threads: int = 4,
           iters: int = 200, switch_interval: float = 1e-5) -> None:
    """Post-fix side of the harness: ``threads`` workers call
    ``fn(worker_index)`` ``iters`` times each under an aggressive
    bytecode switch interval, re-raising the first worker exception.
    A start barrier lines the workers up so contention is real."""
    start = threading.Barrier(threads)
    errors: list = []

    def run(idx: int) -> None:
        try:
            start.wait()
            for _ in range(iters):
                fn(idx)
        except BaseException as e:  # noqa: BLE001 — reported to caller
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(switch_interval)
    try:
        ts = [threading.Thread(target=run, args=(i,), daemon=True,
                               name=f"cxxnet-threadcheck-stress-{i}")
              for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        sys.setswitchinterval(old)
    if errors:
        raise errors[0]


def run_interleaved(first: Callable[[], None],
                    second: Callable[[], None],
                    hook_name: str) -> None:
    """Deterministic two-thread lost-update schedule:

    thread A runs ``first`` and parks at ``hook_name`` (installed here)
    mid-critical-section; thread B then runs ``second`` to completion;
    A resumes.  With an unguarded read-modify-write, A's resumed write
    clobbers B's — the canonical race, forced every time."""
    a_at_hook = threading.Event()
    b_done = threading.Event()
    in_a = threading.local()
    a_errors: list = []

    def gate() -> None:
        # only thread A parks; B passes straight through the hook
        if getattr(in_a, "yes", False):
            a_at_hook.set()
            b_done.wait(timeout=10.0)

    set_hook(hook_name, gate)
    try:
        def run_a() -> None:
            try:
                in_a.yes = True
                first()
            except BaseException as e:  # noqa: BLE001 — reraised below
                a_errors.append(e)
                a_at_hook.set()  # unblock the caller's wait

        ta = threading.Thread(target=run_a, daemon=True,
                              name="cxxnet-threadcheck-a")
        ta.start()
        assert a_at_hook.wait(timeout=10.0), \
            f"fixture never reached hook {hook_name!r}"
        if not a_errors:
            second()
        b_done.set()
        ta.join(timeout=10.0)
        assert not ta.is_alive(), "interleaved thread A did not finish"
        if a_errors:
            raise a_errors[0]
    finally:
        clear_hooks()
