"""Architecture configurations of the port (the GP one)."""
