"""The quality tools of the port: requant_gguf, perplexity and
quality_gate, each run as `python -m ntransformer_tpu_torch.tools.<name>`."""
