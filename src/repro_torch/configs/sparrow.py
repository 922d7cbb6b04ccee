"""The paper's own system config: Sparrow on the splice-site analogue;
counterpart of ``src/repro/configs/sparrow.py``."""

from repro_torch.boosting.scanner import ScannerConfig
from repro_torch.boosting.sparrow import SparrowConfig
from repro_torch.data.splice import SpliceConfig

DATA = SpliceConfig(n=200_000, d=64, num_bins=8, seed=0)


def sparrow_config(n_workers: int = 10, sample_frac: float = 0.1) -> SparrowConfig:
    return SparrowConfig(
        sample_size=int(DATA.n * sample_frac * 0.9),  # 10% of train split
        capacity=256,
        scanner=ScannerConfig(chunk_size=2048, num_bins=DATA.num_bins, gamma0=0.25),
        ess_threshold=0.1,
        n_workers=n_workers,
    )
