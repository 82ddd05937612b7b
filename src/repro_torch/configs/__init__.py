"""Architecture configurations the port supports (granite-8b so far)."""
