from benchmark.readers import idle_share as read  # noqa: F401
