"""CPU tests of the benchmark: references, least work, trace reduction,
the contract of BENCHMARK.json, controls and planted faults."""
