"""Datasets: the splice-site analogue for boosting and synthetic token
batches for the LM stack."""
