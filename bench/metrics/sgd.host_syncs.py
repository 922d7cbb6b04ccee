"""Host syncs a round: the profiler's count of cudaStreamSynchronize and
cudaDeviceSynchronize calls over the traced rounds."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("rounds"):
        return None
    return tr["syncs"] / tr["rounds"]
