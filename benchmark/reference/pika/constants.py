"""World geometry constants of the Pikachu Volleyball physics engine.

Values match the reference engine (``pikazoo/env/physics.py:10-33``): the
court is 432px wide, players are 64x64, the ball has radius 20, and the net
pillar occupies a 50px-wide band around x=216 with its "top" spanning
y in (176, 192].  ``INFINITE_LOOP_LIMIT`` caps the landing-point forward
simulation (the original game's quirky wall bound can make it non-terminating
otherwise).
"""

GROUND_WIDTH = 432
GROUND_HALF_WIDTH = GROUND_WIDTH // 2  # 216; also the net pillar x coordinate
PLAYER_LENGTH = 64
PLAYER_HALF_LENGTH = PLAYER_LENGTH // 2  # 32
PLAYER_TOUCHING_GROUND_Y_COORD = 244
BALL_RADIUS = 20
BALL_TOUCHING_GROUND_Y_COORD = 252
NET_PILLAR_HALF_WIDTH = 25
NET_PILLAR_TOP_TOP_Y_COORD = 176
NET_PILLAR_TOP_BOTTOM_Y_COORD = 192
INFINITE_LOOP_LIMIT = 1000

# Render-only geometry.
GROUND_HEIGHT = 304
