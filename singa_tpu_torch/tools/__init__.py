"""Tools of the port: the serving load harness (``serve_bench``)."""
