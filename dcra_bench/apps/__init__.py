"""The graph apps a traffic mix can name (``"app"``): which of the port's
programs a launch runs, its parameters, the work each launch does, and
the check of the window's answers against the plain reference."""
