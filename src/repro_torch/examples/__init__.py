"""Runnable examples of the port, one for each of the reference's
``examples/*.py``, with its plan, sizes, defaults and printed lines:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.coded_cnn_inference [--batch 4]
    python -m repro_torch.examples.coded_serving [--requests 12]
    python -m repro_torch.examples.coded_lm_layer
    python -m repro_torch.examples.serve_decode [--arch rwkv6-1.6b]
    python -m repro_torch.examples.train_smollm [--steps 300]

Each runs on the card unless ``--device cpu`` asks for the CPU, checks its
own result, and exposes ``main(argv) -> dict`` with the numbers it
prints.  Inputs the reference draws with numpy are the same numpy arrays
here; weights it draws with a jax key are drawn from a ``torch.Generator``
with the same seed (other values: the PRNGs differ).
"""
