"""The reference's examples on the port, each `python -m
nmpc_tpu_torch.examples.<name>` (on the card unless given --device cpu):

    six_robot_swap       the headline demo: six robots swap antipodally
    fleet_batch          thousands of randomized six-robot problems in one shot
    decentralized_cross  four robots cross with per-robot NMPC and plan exchange
"""
