"""Engine time a round (ms): the period between consecutive scan starts,
less the worker calls inside it (scan_round, adopt_batch; CUDA-event
spans), mean over the window. Includes the snapshot ring's model copies."""


def read(rec):
    split = rec.get("split")
    if not split or not split["periods_ms"]:
        return None
    return (sum(split["periods_ms"]) - sum(split["worker_ms"])) / len(split["periods_ms"])
