"""Workloads: the entry points of the port's runs."""
