"""Protocol, stopping rule, ESS, worker contract, run results and the
single-device round engine."""
