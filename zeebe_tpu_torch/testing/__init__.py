"""Workload definitions shared by the smoke run and the tests."""
