"""Concurrent stage execution with per-call timeouts and progress.

A copy of ``s2p_tpu/runner.py`` (standard library only).  The reference
s2p fans tiles out to a ``multiprocessing.Pool`` (its ``parallel.py``);
here host-side work (IO, sparse solves) runs on a thread pool while
device work goes through the one torch CUDA stream of the process, so
workers default to a small thread count.  The public contract matches
the reference's ``launch_calls``: a per-call execution deadline, child
exceptions re-raised on the driver, a ``done K / N tiles`` progress
line, and optional per-tile log redirection.
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import os
import queue
import sys
import threading
import time
import traceback


class TimeoutError_(Exception):
    pass


# cancellation event of the innermost active launch_calls (cooperative
# cancellation: long-running stage functions poll via checkpoint())
_cancel_stack: list = []


def cancelled() -> bool:
    """True when the active launch has been aborted (timeout/error)."""
    return bool(_cancel_stack) and _cancel_stack[-1].is_set()


def checkpoint():
    """Raise inside a worker if the launch was aborted.

    The reference kills hung child PROCESSES (its common.py); device work
    here shares one process with the driver, so stage functions instead call
    this between device launches / pyramid levels to stop promptly once a
    sibling tile times out.
    """
    if cancelled():
        raise TimeoutError_('stage aborted (sibling tile timed out)')


class _StreamRouter(io.TextIOBase):
    """Thread-local stdout/stderr routing.

    ``contextlib.redirect_stdout`` swaps the process-global ``sys.stdout``,
    so concurrent tile workers would capture each other's (and the
    driver's) output.  This router is installed once and routes each
    thread's writes to its registered sink, falling back to the real
    stream (driver progress lines keep going to the terminal).
    """

    def __init__(self, fallback):
        self.fallback = fallback
        self._local = threading.local()

    def push(self, target):
        self._local.target = target

    def pop(self):
        self._local.target = None

    @property
    def _t(self):
        return getattr(self._local, 'target', None) or self.fallback

    def write(self, s):
        return self._t.write(s)

    def flush(self):
        try:
            return self._t.flush()
        except ValueError:
            pass

    def writable(self):
        return True


def _tile_log_path(item):
    if isinstance(item, tuple) and isinstance(item[0], dict):
        return os.path.join(item[0]['dir'], f'pair_{item[1]}', 'stdout.log')
    if isinstance(item, dict) and 'dir' in item:
        return os.path.join(item['dir'], 'stdout.log')
    return None


def launch_calls(fun, list_of_args, nb_workers=None, *extra_args,
                 tilewise=True, timeout=600, debug=False,
                 warmup_first=False):
    """Run ``fun`` over work items concurrently.

    Args:
        fun: callable; called as fun(*item, *extra_args) when the item is a
            tuple, else fun(item, *extra_args).
        list_of_args: work items.
        nb_workers: thread count (None = min(8, n_items)).
        tilewise: when True, each call's stdout/stderr is appended to the
            tile's stdout.log (unless debug).
        timeout: seconds to wait for each call before raising.
        warmup_first: run the FIRST item alone with no deadline before
            fanning out the rest.  For stage functions whose first call
            builds device kernels, this excludes the build from the
            execution deadline.

    Returns:
        list of results in input order; raises the first child exception.
    """
    n = len(list_of_args)
    if n == 0:
        return []
    if warmup_first and timeout is not None:
        head = launch_calls(fun, list_of_args[:1], 1, *extra_args,
                            tilewise=tilewise, timeout=None, debug=debug)
        tail = launch_calls(fun, list_of_args[1:], nb_workers, *extra_args,
                            tilewise=tilewise, timeout=timeout, debug=debug)
        return head + tail
    nb_workers = nb_workers or min(8, n)
    done_count = [0]

    router_out = _StreamRouter(sys.stdout)
    router_err = _StreamRouter(sys.stderr)

    def call(item):
        args = tuple(item) if isinstance(item, tuple) else (item,)
        args += tuple(extra_args)
        log = _tile_log_path(item) if tilewise else None
        if log and not debug:
            os.makedirs(os.path.dirname(log), exist_ok=True)
            buf = io.StringIO()
            router_out.push(buf)
            router_err.push(buf)
            try:
                out = fun(*args)
            except Exception:
                buf.write(f'Exception in {getattr(fun, "__name__", fun)}\n')
                buf.write(traceback.format_exc())
                raise
            finally:
                router_out.pop()
                router_err.pop()
                with open(log, 'a') as f:
                    f.write(buf.getvalue())
            return out
        return fun(*args)

    # Daemon-thread pool with per-call EXECUTION deadlines: each call's
    # budget starts when it begins running (not when the driver happens to
    # wait on it), so a slow early tile cannot eat later tiles' budgets;
    # on timeout the cancellation event is set (workers poll checkpoint())
    # and the daemon threads can never block interpreter exit.  This is the
    # in-process analogue of the reference's child-process kill
    # (its parallel.py and common.py).
    work: queue.Queue = queue.Queue()
    for i, item in enumerate(list_of_args):
        work.put((i, item))
    results = [None] * n
    events: queue.Queue = queue.Queue()   # (idx, 'ok'|'err', payload)
    starts = {}
    lock = threading.Lock()
    cancel = threading.Event()

    def worker():
        while not cancel.is_set():
            try:
                i, item = work.get_nowait()
            except queue.Empty:
                return
            with lock:
                starts[i] = time.monotonic()
            try:
                r = call(item)
                with lock:
                    starts.pop(i, None)
                events.put((i, 'ok', r))
            except BaseException as e:  # noqa: BLE001 - re-raised on driver
                with lock:
                    starts.pop(i, None)
                events.put((i, 'err', e))

    saved = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = router_out, router_err
    _cancel_stack.append(cancel)
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(min(nb_workers, n))]
    try:
        for t in threads:
            t.start()
        while done_count[0] < n:
            try:
                i, kind, payload = events.get(timeout=0.25)
            except queue.Empty:
                now = time.monotonic()
                with lock:
                    overdue = [i for i, t0 in starts.items()
                               if timeout is not None and now - t0 > timeout]
                if overdue:
                    cancel.set()
                    # grace join: cooperative workers (checkpoint()) exit
                    # promptly; a thread stuck inside a device call stays
                    # daemon and must not be waited on forever
                    deadline = time.monotonic() + 10.0
                    for t in threads:
                        t.join(max(0.0, deadline - time.monotonic()))
                    raise TimeoutError_(
                        f'tile call {overdue[0]} did not complete within '
                        f'{timeout} s')
                continue
            if kind == 'err':
                cancel.set()
                raise payload
            results[i] = payload
            done_count[0] += 1
            status = 'done {} / {} tiles'.format(done_count[0], n)
            end = '\n' if done_count[0] == n else '\r'
            router_out.fallback.write(status + end)
            router_out.fallback.flush()
    except KeyboardInterrupt:
        cancel.set()
        raise
    finally:
        _cancel_stack.pop()
        sys.stdout, sys.stderr = saved
    return results


class SerialRunner:
    """Runner facade with :class:`PoolRunner`'s ``map``, run in order on
    the caller's thread."""

    def map(self, fun, items):
        return [fun(i) for i in items]


class PoolRunner:
    """Runner facade over launch_calls: per-call EXECUTION deadlines and
    cooperative cancellation, same semantics as the stage fan-out."""

    def __init__(self, nb_workers=None, timeout=600):
        self.nb_workers = nb_workers
        self.timeout = timeout

    def map(self, fun, items):
        # map semantics: fun(item) even for tuple items -- wrap each item
        # in a 1-tuple since launch_calls unpacks tuple work items as *args
        items = [(i,) for i in items]
        nb = self.nb_workers or min(8, max(1, len(items)))
        return launch_calls(fun, items, nb, timeout=self.timeout,
                            tilewise=False)
