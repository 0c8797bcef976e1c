"""Probes of the port's kernels, run on a card by hand; nothing imports them."""
