"""The plain reference: RAFT, its loss and its optimizer in PyTorch."""
