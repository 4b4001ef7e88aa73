"""The sparse-histogram experiments of the reference library, run with
``python -m``: ``gen_data`` writes the synthetic inputs,
``synthetic_data_benchmarks`` evaluates one key over them on the card."""
