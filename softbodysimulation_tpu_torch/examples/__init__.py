"""Examples of the port (counterparts of the JAX package's
``examples/config*.py``); each runs on the card unless asked for the CPU."""
