"""Serving side of the port; counterpart of ``src/repro/launch`` (only the
adoption slot so far)."""
