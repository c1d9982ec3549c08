from ..i3dnl import I3DResNetNonLocal as Backbone  # noqa: F401
