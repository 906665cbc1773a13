"""The benchmark's harness: cells, traffic generators, probes, traces,
rooflines and the comparison that decides `correct`."""
