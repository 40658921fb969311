"""The tokenizer's worker processes, for the batch plane's large jobs.

The port's ``tokenizer.json`` reader (:mod:`.tokenizer`) is plain Python and
holds the interpreter lock while it encodes, so a thread that encodes slows
every kernel launch of the thread that dispatches the forwards. A
:class:`TokenizerPool` runs those encodes in worker processes. Each worker
builds one :class:`.tokenizer.Tokenizer` when it starts, from the file's
parsed spec (written once to a temporary file, never sent with a task). A
task names one of :mod:`.tokenization`'s module-level encoders, the same
function the in-thread path runs, and returns the finished, padded
:class:`.tokenization.TokenizedBatch` of its chunk with the worker's own
encode time in ms.

Each worker is a fresh interpreter, ``python -m
gliclass.c_tpu_torch.tokenize_pool``. It imports this module, which imports
neither torch nor CUDA, and never the caller's ``__main__``: a script
without an ``if __name__ == "__main__":`` guard is not run again in it (as
``multiprocessing``'s spawn would), and nothing of the parent's CUDA state
or threads is copied (as a fork would). It takes the parent's ``sys.path``
with the spec, then answers pickled tasks on its standard input, each
prefixed by its length, one at a time, until that input closes; it closes
too when the parent dies. In the parent one thread serves each worker,
taking the next task from a queue that the workers share.
:meth:`.tokenization.PromptTokenizer.pool` starts a pool on first use; the
pool shuts down, its workers ended and joined, when the tokenizer drops it
or at exit.
"""

from __future__ import annotations

import os
import pickle
import queue
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import weakref
from concurrent.futures import Future

from . import tokenization
from .tokenizer import Tokenizer

# The directory that holds the ``gliclass`` package, for the workers' -m.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class TokenizerPoolBroken(RuntimeError):
    """A worker of the tokenizer pool died (killed, out of memory, failed to
    start): the job that waited on it fails whole."""


class _RemoteTraceback(Exception):
    """The worker's traceback of an encode error, as its ``__cause__``."""

    def __str__(self) -> str:
        return self.args[0]


class TokenizerPool:
    """``workers`` processes, each holding ``tokenizer``; see the module
    docstring."""

    def __init__(self, tokenizer: Tokenizer, workers: int):
        self.workers = int(workers)
        self._tasks: queue.SimpleQueue = queue.SimpleQueue()
        self._broken = threading.Event()
        self._procs: list[subprocess.Popen] = []
        procs, threads = self._procs, []
        # The spec goes by file: through a worker's input it would hold up
        # this thread until the worker had started and read it.
        fd, spec_path = tempfile.mkstemp(prefix="gliclass-tokenizer-", suffix=".pickle")
        self._finalizer = weakref.finalize(self, _shut_down, procs, threads, self._tasks, spec_path)
        with os.fdopen(fd, "wb") as f:
            pickle.dump((list(sys.path), tokenizer._spec), f, pickle.HIGHEST_PROTOCOL)
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, PYTHONPATH=_ROOT + (os.pathsep + path if path else ""))
        for _ in range(self.workers):
            proc = subprocess.Popen([sys.executable, "-m", __name__, spec_path], stdin=subprocess.PIPE,
                                    stdout=subprocess.PIPE, env=env)
            procs.append(proc)
            threads.append(threading.Thread(target=_serve, args=(proc, self._tasks, self._broken, self.workers),
                                            name=f"tokenizer-pool-{proc.pid}", daemon=True))
            threads[-1].start()

    @property
    def broken(self) -> bool:
        return self._broken.is_set()

    def submit(self, task: tokenization.EncodeTask) -> Future:
        """``task``, ``(fn, args)``, as ``fn(tokenizer, *args)`` in a worker;
        read it with :meth:`result`. The task is pickled here, so what
        cannot be pickled raises here."""
        if not self._finalizer.alive:
            raise RuntimeError("the tokenizer worker pool is shut down")
        if self.broken:
            raise _broken_error(self.workers, "an earlier task found a worker dead")
        fut: Future = Future()
        self._tasks.put((fut, pickle.dumps(task, pickle.HIGHEST_PROTOCOL)))
        return fut

    def result(self, fut: Future) -> tuple[tokenization.TokenizedBatch, float]:
        """A task's batch and the worker's encode ms. An exception the
        encode raised is raised here as it was, the worker's traceback its
        cause; a dead worker raises :class:`TokenizerPoolBroken`."""
        return fut.result()

    def close(self) -> None:
        """Shut the workers down and join them (once; also when the pool is
        freed, and at exit)."""
        self._finalizer()


def _broken_error(workers: int, why: str) -> TokenizerPoolBroken:
    return TokenizerPoolBroken(f"the tokenizer worker pool ({workers} processes) broke: {why}")


def _serve(proc: subprocess.Popen, tasks: queue.SimpleQueue, broken: threading.Event, workers: int) -> None:
    """One worker's thread: each task it takes goes to the worker, and the
    answer to the task's future. Once the worker is dead, every task it
    takes fails, so that no task waits on a pool that cannot run it."""
    why = None
    while (item := tasks.get()) is not None:
        fut, payload = item
        if not fut.set_running_or_notify_cancel():
            continue
        if why is None:
            try:
                _send(proc.stdin, payload)
                answer = _receive(proc.stdout)
            except (OSError, EOFError) as e:
                try:
                    code = proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    code = None
                why = f"worker {proc.pid} ended (exit code {code}; {type(e).__name__})"
                broken.set()
            else:
                try:
                    ok, value, ms = pickle.loads(answer)
                except Exception as e:
                    fut.set_exception(e)
                    continue
                if ok:
                    fut.set_result((value, ms))
                else:
                    exc, tb = value
                    exc.__cause__ = _RemoteTraceback(tb)
                    fut.set_exception(exc)
                continue
        fut.set_exception(_broken_error(workers, why))


def _shut_down(procs: list, threads: list, tasks: queue.SimpleQueue, spec_path: str) -> None:
    """Cancel the tasks no worker has taken, let each thread finish its
    own, close the workers' input (they end) and join them."""
    while True:
        try:
            item = tasks.get_nowait()
        except queue.Empty:
            break
        if item is not None:
            item[0].cancel()
    for _ in threads:
        tasks.put(None)
    for t in threads:
        if t is not threading.current_thread():
            t.join()
    for proc in procs:
        try:
            proc.stdin.close()
        except OSError:
            pass
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    os.unlink(spec_path)


def _send(f, data: bytes) -> None:
    f.write(len(data).to_bytes(8, "little"))
    f.write(data)
    f.flush()


def _receive(f) -> bytes:
    """One message of :func:`_send`; EOFError when the stream ends first."""
    head = f.read(8)
    data = f.read(int.from_bytes(head, "little")) if len(head) == 8 else b""
    if len(head) < 8 or len(data) < int.from_bytes(head, "little"):
        raise EOFError("the stream ended inside a message")
    return data


def _portable(e: Exception, tb: str) -> tuple[Exception, str]:
    """``e`` if it survives pickling, else a RuntimeError that names it."""
    try:
        pickle.loads(pickle.dumps(e))
        return e, tb
    except Exception:
        return RuntimeError(f"{type(e).__qualname__}: {e}"), tb


def _work(spec_path: str) -> None:
    """A worker: the tokenizer from ``spec_path``, then one answer for each
    task on standard input until it closes."""
    with open(spec_path, "rb") as f:
        path, spec = pickle.load(f)
    sys.path[:] = path
    tok = Tokenizer(spec)
    # The answers go out on the original standard output; whatever an
    # encoder prints goes to standard error.
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    inp = sys.stdin.buffer
    while True:
        try:
            task = _receive(inp)
        except EOFError:
            return
        t0 = time.perf_counter_ns()
        try:
            fn, args = pickle.loads(task)
            answer = (True, fn(tok, *args), (time.perf_counter_ns() - t0) / 1e6)
        except Exception as e:
            answer = (False, _portable(e, traceback.format_exc()), 0.0)
        _send(out, pickle.dumps(answer, pickle.HIGHEST_PROTOCOL))

if __name__ == "__main__":
    _work(sys.argv[1])
