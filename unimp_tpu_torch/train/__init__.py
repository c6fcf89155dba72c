"""Rec training: loss, freezing, optimizer and the train step."""
