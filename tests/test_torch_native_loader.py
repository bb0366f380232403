"""The port's msac loader (``libavif_tpu_torch/native/__init__.py``) on a
first use from several processes and threads at once.

Each worker loads its own copy of the loader module (so no in-process
lock is shared), pointed at a scratch directory, with the compiler
stubbed by one that writes its output in two halves with a pause between,
and ``ctypes.CDLL`` stubbed by one that records whether the file it is
handed is whole. No ``g++`` runs. The loader must build once, and every
worker must load the whole library.
"""

import json
import pathlib
import subprocess
import sys
import time

import pytest

LOADER = pathlib.Path(__file__).resolve().parent.parent / "libavif_tpu_torch" / "native" / "__init__.py"

_WORKER = r"""
import ctypes, importlib.util, json, os, pathlib, sys, threading, time, types

loader, workdir, start_at, threads, fail = sys.argv[1:]
workdir, start_at, threads, fail = pathlib.Path(workdir), float(start_at), int(threads), fail == "1"
PAYLOAD = bytes(range(256)) * 64  # the stub library


class BuildError(Exception):
    pass


def run(cmd, **kwargs):
    # The stub compiler: logs the build, then writes its output in halves.
    with open(workdir / "builds.log", "a") as log:
        log.write(f"{os.getpid()} {threading.get_ident()}\n")
    out = pathlib.Path(cmd[cmd.index("-o") + 1])
    with open(out, "wb") as f:
        f.write(PAYLOAD[: len(PAYLOAD) // 2])
        f.flush()
        time.sleep(0.3)
        if fail:
            raise BuildError(cmd)
        f.write(PAYLOAD[len(PAYLOAD) // 2 :])


class Lib:
    # takes the loader's restype/argtypes settings for any symbol
    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def worker(results):
    spec = importlib.util.spec_from_file_location(f"msac_loader_{threading.get_ident()}", loader)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._DIR, mod._SRC = workdir, workdir / "msac.cc"
    mod.subprocess = types.SimpleNamespace(run=run)
    whole = []

    def cdll(path):
        whole.append(pathlib.Path(path).read_bytes() == PAYLOAD)
        return Lib()

    names = {k: getattr(ctypes, k) for k in dir(ctypes) if not k.startswith("__")}
    mod.ctypes = types.SimpleNamespace(**{**names, "CDLL": cdll})
    time.sleep(max(0.0, start_at - time.time()))
    lib = mod.load()
    results.append({"lib": lib is not None, "whole": whole})


results = []
pool = [threading.Thread(target=worker, args=(results,)) for _ in range(threads)]
for t in pool:
    t.start()
for t in pool:
    t.join()
print(json.dumps(results))
"""


def _run_workers(tmp_path, processes: int, threads: int, fail: bool = False) -> list:
    (tmp_path / "msac.cc").write_text("// the source the loader hashes\n")
    start_at = time.time() + 1.0  # every worker has started by then
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(LOADER), str(tmp_path), str(start_at), str(threads),
             "1" if fail else "0"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(processes)
    ]
    results = []
    for proc in procs:
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        results += json.loads(out.strip().splitlines()[-1])
    return results


@pytest.mark.parametrize("processes,threads", [(4, 1), (1, 4), (3, 3)],
                         ids=["processes", "threads", "both"])
def test_concurrent_first_use_builds_once_and_loads_whole_files(tmp_path, processes, threads):
    results = _run_workers(tmp_path, processes, threads)
    assert len(results) == processes * threads
    assert all(r["lib"] for r in results)
    assert all(r["whole"] == [True] for r in results)  # one CDLL each, of the whole file
    assert len((tmp_path / "builds.log").read_text().splitlines()) == 1
    libs = sorted(p.name for p in tmp_path.glob("_msac_*"))
    assert len(libs) == 2 and libs[0].endswith(".so") and libs[1] == libs[0] + ".lock"  # no private copy left


def test_failed_build_leaves_no_library(tmp_path):
    results = _run_workers(tmp_path, 2, 1, fail=True)
    assert [r["lib"] for r in results] == [False, False]
    assert all(r["whole"] == [] for r in results)  # nothing was loaded
    assert not list(tmp_path.glob("_msac_*.so")) and not list(tmp_path.glob("_msac_*.tmp"))
