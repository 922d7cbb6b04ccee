"""Datasets."""
