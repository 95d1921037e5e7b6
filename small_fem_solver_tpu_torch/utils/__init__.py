"""Result persistence and resumable envelopes."""
