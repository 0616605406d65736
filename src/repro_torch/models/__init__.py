"""The port's workloads: the paper's CNN ConvL stacks (``cnn``) and the
decoder LM (``transformer``, with ``moe``): dense GQA, MLA and MoE stacks,
the dense GQA one also served by the coded LM path."""
