"""MoD routing: routers and the routed-execution engine."""
