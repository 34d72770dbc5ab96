"""Fixture: unguarded in-process CUDA queries the port's rule 2 must flag."""
import torch
import torch.cuda as tc
from torch.cuda import mem_get_info


def boot():
    return torch.cuda.device_count()       # line 8: unguarded card query


def boot_aliased():
    return tc.is_available()               # line 12: aliased module


def free_bytes():
    return mem_get_info()[0]               # line 16: imported name


def wait_for_the_card():
    torch.cuda.synchronize()               # a launch fence, not a query
