"""Fixture: the sanctioned shape — the card is asked only inside the probe
(zero findings; this file is pointed at by the test as an allowed
location)."""
import torch


def probe_child():
    return torch.cuda.is_available() and torch.cuda.device_count()


def boot():
    return probe_child()
