"""Cost models of the LM cells (``analytic``)."""
