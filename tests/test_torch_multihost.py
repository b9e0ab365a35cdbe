"""The port's multi-process path (fastpyvectordb_tpu_torch/dist/multihost.py
over torch.distributed): two gloo processes on localhost, two CPU shards
each, run initialize -> global_mesh -> shard_local_corpus and sharded
searches against a host truth (tests/torch_multihost_worker.py); the port's
counterpart of tests/test_multihost.py."""

import os
import socket
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_multihost_worker.py")
NPROC = 2
TIMEOUT = 120   # seconds a worker may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_sharded_search():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(pid), str(NPROC), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for pid in range(NPROC)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIHOST_OK pid={pid}" in out, out
