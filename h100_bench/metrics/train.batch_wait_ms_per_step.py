"""``train.batch_wait_ms_per_step``: host ms a step the unit thread spends
starting the ``Prefetcher`` (``batch.start``) and waiting for its worker's
batches (``batch.wait``) (layer: batch pipeline)."""

from h100_bench.harness.spans import host_s, per_unit_ms


def read(run):
    parts = [host_s(run.events, run.win, name)
             for name in ("batch.start", "batch.wait")]
    parts = [p for p in parts if p is not None]
    return per_unit_ms(sum(parts) if parts else None,
                       run.counts.get("steps", 0))
