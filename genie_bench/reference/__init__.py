"""Plain references of the deployments, with their inputs and least-work
counts.  They import torch and nothing of the program under test."""
