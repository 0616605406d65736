"""The paper's CNN workloads (ConvL stacks) for the coded pipeline."""
