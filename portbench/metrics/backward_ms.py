"""Device ms per step of the operations launched while the ``backward`` span
was open (the autograd engine's thread launches them): cuDNN dgrad and
wgrad, BN backward, K3/K4, K2's dx."""


def read(summary):
    return summary["span_ms"].get("backward")
