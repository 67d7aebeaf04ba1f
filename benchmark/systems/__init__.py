"""How each configuration's system is built from the program.

One module per ``system`` named in a configuration file. Each gives
``make_weights(cfg, seed, device)``, the float32 inputs the benchmark draws
and hands to both the program and the reference; ``build(cfg, weights,
centers, device)``, the program's encoder; and ``FEATURES``, the name of
the extractor's public method that the benchmark wraps in its
``features`` range.
"""
