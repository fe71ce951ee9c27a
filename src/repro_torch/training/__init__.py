"""Dense ranking metrics (the reference the streaming evaluator is held to)."""
