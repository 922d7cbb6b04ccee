"""Adoption time a round (ms): the adopt_batch spans (the adopted models'
copies into the workers' rows) over the window's rounds."""


def read(rec):
    if "adopt_ms" not in rec or not rec.get("rounds_spanned"):
        return None
    return rec["adopt_ms"] / rec["rounds_spanned"]
