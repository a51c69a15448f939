"""The benchmark's own code: inputs from the seed, the reduction of the
profiler's trace, the correctness check and the table of peaks."""
