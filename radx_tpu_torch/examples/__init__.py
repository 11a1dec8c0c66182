"""Examples of the port (run as modules, e.g.
``python -m radx_tpu_torch.examples.query_pipeline``, on the card unless
``--device cpu``)."""
