"""The data-parallel path (the flagship under DDP, the path a four-card cell
takes) across two gloo ranks on the CPU: every rank's record reaches rank 0,
the other ranks return nothing, and DDP's gradient all-reduce left out moves
the first gradient's reading far from the sound run's and parts the replicas,
which the sound run keeps identical. The subjects' PET gains
differ, so that each rank's rows give a gradient of their own."""

import json
import os
import subprocess
import sys

from portbench import harness
from portbench.run import free_port

ROOT = os.path.dirname(harness.PKG)
CELL = "flagship.train.b4"


def _ranks(fault, world=2):
    code = (f"import sys, json, torch; sys.path.insert(0, {ROOT!r}); torch.set_num_threads(2); "
            "from portbench import check, harness; keep = {}; "
            f"r = harness.run({CELL!r}, 2**31 + 21, 0.0, False, 'cpu', fault={fault!r}, "
            "overrides={'volume': [32, 32, 32], 'subjects': 8, 'batch': 4, 'pet_gain': [0.4, 1.0]}, "
            "log=lambda s: None, keep=keep); "
            "print(json.dumps({'result': r, 'ranks': len(keep.get('ranks', [])), "
            "'values': dict(check.readings(keep['prog'], keep['want']), replicas=check.replicas(keep['ranks'])) "
            "if keep else None}))")
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=900)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * world
    lead, *others = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert all(o["result"] == {} and o["values"] is None for o in others)
    assert lead["ranks"] == world and lead["result"]["device"]["count"] == world
    return lead["values"]


def test_two_ranks_and_the_exchange_left_out():
    sound, broken = _ranks(None), _ranks("no_exchange")
    assert broken["grad"] > 5 * sound["grad"]
    assert sound["replicas"] == 0 and broken["replicas"] > 0.05
