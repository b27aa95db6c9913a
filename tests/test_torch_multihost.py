"""Two processes join through the port's ShardEngine: the counterpart of
``tests/test_parallel.py::TestMultiHost::test_two_process_shard_engine``.

Each process sets ``WDBX_COORDINATOR_ADDRESS`` / ``WDBX_NUM_PROCESSES`` /
``WDBX_PROCESS_ID`` and initializes a ``ShardEngine`` on 4 logical CPU
positions: ``torch.distributed`` (gloo) joins them, the allocation
reports the rank and the world size, every shard of a process's mesh is
local to it, and a gloo all-reduce proves the control plane is up. The
global mesh over both processes (the JAX case's 8 shards) is not
ported, nor is the cross-process data plane
(``test_two_process_data_plane``).
"""

import socket
import subprocess
import sys

WORKER = r"""
import asyncio, os, sys
sys.path.insert(0, os.getcwd())
port, pid, data_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
os.environ.update(WDBX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                  WDBX_NUM_PROCESSES="2", WDBX_PROCESS_ID=str(pid),
                  WDBX_TORCH_MESH_SIZE="4")
import torch
import torch.distributed as dist
from wdbx_tpu_torch.core.config import WDBXConfig
from wdbx_tpu_torch.parallel.shard_engine import ShardEngine

engine = ShardEngine(WDBXConfig({"DATA_DIR": os.path.join(data_dir, str(pid))}),
                     device="cpu")
asyncio.run(engine.initialize())
alloc = engine.allocation()
assert alloc["process_count"] == 2, alloc["process_count"]
assert alloc["process_index"] == pid, alloc["process_index"]
n = len(alloc["shards"])
assert n == 4, n  # this process's own positions
local = [s for s in range(n) if engine.is_local_shard(s)]
assert len(local) == 4, local
total = torch.ones(1) * (pid + 1)
dist.all_reduce(total)
assert float(total) == 3.0, float(total)
assert engine.get_stats()["process_count"] == 2
asyncio.run(engine.shutdown())
assert not dist.is_initialized()
print(f"proc{pid} OK local={local}", flush=True)
"""


def test_two_process_shard_engine(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(pid),
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    for rc, out in outs:
        assert rc == 0, f"worker failed rc={rc}:\n{out[-2000:]}"
    assert "proc0 OK" in outs[0][1] and "proc1 OK" in outs[1][1]
