"""Resource model, IP contract, IP library and the network planner."""
