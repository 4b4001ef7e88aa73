"""The port's demos, run with ``python -m``: two-server PIR
(``pir_demo``), private heavy hitters (``heavy_hitters_demo``) and secure
ReLU / sigmoid layers (``secure_relu_demo``), each on the card unless
``--device cpu`` is passed."""
