"""The reader of the pool's shared-memory counter on a synthetic run
record: nothing where the program does not count it or sent no batch."""
from portbench.tests.test_metrics import read, record  # noqa: F401


def test_lk_shm_pct(record):  # noqa: F811
    # a program without the counter (the record's 40 "lk" batches alone)
    assert read("pool.lk_shm_pct", record) is None
    record["worker_counts"]["lk_shm_batches"] = 40
    assert read("pool.lk_shm_pct", record) == 100.0
    record["worker_counts"]["lk_shm_batches"] = 30
    assert read("pool.lk_shm_pct", record) == 75.0
    record["worker_counts"].update(lk_batches=0, lk_shm_batches=0)
    assert read("pool.lk_shm_pct", record) is None
