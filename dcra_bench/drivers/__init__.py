"""Drivers: one a kind of deployment, named by a configuration's
``"driver"``. Each exposes ``run(ctx) -> harness.Run``."""
