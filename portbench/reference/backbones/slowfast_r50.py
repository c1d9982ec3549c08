from ..slowfast import SlowFast as Backbone  # noqa: F401
