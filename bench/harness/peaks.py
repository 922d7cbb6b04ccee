"""Published peak of one NVIDIA H100 SXM (NVIDIA data sheet, dense
rate, at the full 700 W power limit): every utilisation share of the
benchmark is taken against it, with the card's power limit printed
beside it."""

BF16_FLOPS = 989e12
