"""The plain reference: exact answers, the comparison, the control."""
