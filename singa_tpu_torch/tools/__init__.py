"""Tools of the port: the serving load harness (``serve_bench``), the
sampling CLI for conf-trained LMs (``generate``) and the timing of
design variants of the bf16 flash backward (``flash_bwd_variants``)."""
