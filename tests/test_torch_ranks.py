"""``tests/torch_ranks.py``, the spawned-rank fixture of the mesh tests, on
worlds of two ranks: what it returns, and what it reports when a rank fails
or the world outlives its deadline (every rank's exit code and the tail of
its log, the stacks that ``faulthandler`` dumped before the deadline)."""

import pytest
from torch_ranks import spawn_ranks

OK = r'''
import json, sys
rank = int(sys.argv[1])
_dist.barrier()
with open(sys.argv[4], "w") as f:
    json.dump({"rank": rank, "arg": sys.argv[5]}, f)
'''

ONE_FAILS = r'''
import json, sys, time
rank = int(sys.argv[1])
print(f"rank {rank} starts", flush=True)
if rank == 1:
    raise SystemExit("rank one stops here")
time.sleep(1)
with open(sys.argv[4], "w") as f:
    json.dump({"rank": rank}, f)
'''

HANGS = r'''
import time
def stuck_here():
    time.sleep(600)
stuck_here()
'''


def test_results_come_back_in_rank_order(tmp_path_factory):
    got = spawn_ranks(tmp_path_factory, "ok", OK, 2, ["x"])
    assert got == [{"rank": 0, "arg": "x"}, {"rank": 1, "arg": "x"}]


def test_a_failing_rank_is_reported_with_every_log(tmp_path_factory):
    with pytest.raises(AssertionError) as err:
        spawn_ranks(tmp_path_factory, "fails", ONE_FAILS, 2)
    text = str(err.value)
    assert "stopped by a rank's failure" in text and "return codes [0, 1]" in text
    assert "rank 0 starts" in text and "rank one stops here" in text


def test_the_deadline_dumps_each_rank_stack(tmp_path_factory):
    """Each rank's stacks reach its log at half the deadline here, wherever
    the rank then is (under load it may still be importing torch)."""
    with pytest.raises(AssertionError) as err:
        spawn_ranks(tmp_path_factory, "hangs", HANGS, 2, deadline_s=12.0)
    text = str(err.value)
    assert "stopped by the deadline" in text and "return codes [-9, -9]" in text
    # nothing raised (both were killed): the frames in each log are faulthandler's dump
    ranks = text.split("--- rank ")[1:]
    assert len(ranks) == 2 and all('File "' in r for r in ranks)
