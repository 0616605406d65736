"""The port's workloads: the paper's CNN ConvL stacks (``cnn``) and the
dense GQA decoder LM (``transformer``) served by the coded LM path."""
