"""Run a function on K gloo ranks on the CPU, for the port's distributed
tests (tests/test_torch_parallel.py, test_torch_ddp_*.py).

`run_ranks(fn, world, *args, timeout=...)` starts one child interpreter
that spawns `world` processes with torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR=localhost, MASTER_PORT). As under
torchrun, the rendezvous store is the spawner's: it binds a TCPStore to a
port the system picks (port 0) before any rank starts, and the ranks join
it as clients (TORCHELASTIC_USE_AGENT_STORE). So no port is released
between being picked and being bound, where a concurrent run (pytest
workers in parallel) could take it and two runs would meet in one store.
Each rank joins the gloo group (unless `init=False`: then `fn` joins it
itself, through env://) and calls `fn(rank, world, *args)`; the return
values come back pickled, in rank order. `fn` must live in a module that imports neither JAX nor the JAX
package (tests/_torch_ddp_workers.py), so the ranks start quickly. A rank
that raises, or a run past `timeout` seconds (a hung rendezvous), fails
the call, and every process of the run is killed.
"""

import datetime
import importlib
import os
import pickle
import signal
import subprocess
import sys
import tempfile

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
# The ranks' collectives wait this long for a peer (a rank starting slowly
# on a loaded host); `run_ranks`' own timeout bounds the whole run.
PG_TIMEOUT = datetime.timedelta(seconds=300)


def run_ranks(fn, world: int, *args, timeout: float = 300, init: bool = True) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump((fn.__module__, fn.__name__, world, args, tmp, init), f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([TESTS, ROOT]), OMP_NUM_THREADS="1")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "GNERF_DISTRIBUTED"):
            env.pop(k, None)
        proc = subprocess.Popen([sys.executable, "-m", "_torch_dist", spec], env=env, cwd=ROOT,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
            raise AssertionError(f"{fn.__name__} on {world} ranks ran past {timeout} s:\n"
                                 + out[-4000:])
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        assert proc.returncode == 0, f"{fn.__name__} on {world} ranks failed:\n" + out[-6000:]
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _rank_main(rank, module, name, world, args, tmp, port, init):
    import torch
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      TORCHELASTIC_USE_AGENT_STORE="True")
    torch.set_num_threads(1)
    if init:
        dist.init_process_group("gloo", timeout=PG_TIMEOUT)
    try:
        out = getattr(importlib.import_module(module), name)(rank, world, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # Skip the interpreter's teardown: gloo's threads abort it (std::terminate)
    # while a peer still holds connections to this rank.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from _torch_dist import _rank_main as entry

    with open(sys.argv[1], "rb") as f:
        module, name, world, args, tmp, init = pickle.load(f)
    # The rendezvous store, as torchrun's agent hosts it, alive until the
    # ranks are done.
    store = dist.TCPStore("localhost", 0, is_master=True, wait_for_workers=False,
                          timeout=PG_TIMEOUT)
    mp.spawn(entry, args=(module, name, world, args, tmp, store.port, init), nprocs=world,
             join=True)
