"""The classifier CLI of the port."""
