"""The benchmark's harness: cells found by name, inputs from the seed, the
timed window, the trace's reduction and the check against the
reference."""
