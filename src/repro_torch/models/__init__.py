"""Dense model math."""
