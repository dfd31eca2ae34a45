"""QA template generation over 3D object pairs.

Rebuild of dataset_pipeline/osdsynth/processor/prompt.py: the 18
qualitative predicate/choice families and 6 quantitative generators, with
the exact geometric decision rules (x-left convention: ``is_left`` <=>
A.center.x > B.center.x, prompt.py:10-31; wide/tall/big from AABB extents;
clock direction on the (x, z) ground plane; distances via symmetric mean
point-cloud distance).  Template wordings are our own paraphrase bank with
the same [A]/[B]/[X] slot structure.

The port's own copy of ``spatialrgpt_tpu/synth/prompts.py``.
"""

from __future__ import annotations

import random
from itertools import combinations
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from spatialrgpt_tpu_torch.synth.geometry import (
    PointCloud,
    average_cloud_distance,
    calculate_angle_clockwise,
    human_like_distance,
)

# ---------------------------------------------------------------------------
# Template banks (own wording, same slot structure)
# ---------------------------------------------------------------------------

T = Dict[str, List[str]]

# >= 8 paraphrases per family (the reference's prompt_template.py carries
# 16+ per family; language diversity of the synthesized data tracks the
# size of this bank — all wordings here are our own)

PREDICATE_TEMPLATES: T = {
    "left_q": [
        "Is [A] to the left of [B]?",
        "From the viewer's perspective, does [A] appear on the left side of [B]?",
        "Would you say [A] is positioned left of [B]?",
        "Looking at the image, is [A] situated to the left of [B]?",
        "Does [A] lie on the left-hand side of [B]?",
        "Can [A] be found left of [B] in this scene?",
        "In this picture, is [A] placed further left than [B]?",
        "Is the position of [A] more to the left compared with [B]?",
        "Checking their placement, is [A] on [B]'s left?",
    ],
    "left_true": [
        "Yes, [A] is to the left of [B].",
        "Correct, you will find [A] on the left side of [B].",
        "Indeed, [A] sits left of [B].",
        "That's right — [A] appears on the left-hand side of [B].",
        "Yes, in this view [A] is positioned further left than [B].",
        "Affirmative: [A] lies to the left of [B].",
        "Yes — relative to [B], [A] is on the left.",
        "It is — [A] is placed left of [B] in the scene.",
    ],
    "left_false": [
        "No, [A] is not on the left of [B].",
        "Incorrect, [A] is actually to the right of [B].",
        "No — you will find [A] on the right side of [B].",
        "That's not the case; [A] sits right of [B].",
        "No, in this view [A] appears further right than [B].",
        "Negative: [A] lies to the right of [B].",
        "No — relative to [B], [A] is on the right.",
        "It isn't — [A] is placed right of [B] in the scene.",
    ],
    "right_q": [
        "Is [A] to the right of [B]?",
        "Does [A] sit on the right side of [B] from this view?",
        "Would you describe [A] as being right of [B]?",
        "Looking at the image, is [A] situated to the right of [B]?",
        "Does [A] lie on the right-hand side of [B]?",
        "Can [A] be found right of [B] in this scene?",
        "In this picture, is [A] placed further right than [B]?",
        "Checking their placement, is [A] on [B]'s right?",
    ],
    "right_true": [
        "Yes, [A] is to the right of [B].",
        "Correct — [A] sits on the right side of [B].",
        "Indeed, [A] appears right of [B].",
        "That's right; [A] is positioned further right than [B].",
        "Affirmative: [A] lies to the right of [B].",
        "Yes — relative to [B], [A] is on the right.",
        "Yes, in this view [A] is on the right-hand side of [B].",
        "It is — [A] is placed right of [B] in the scene.",
    ],
    "right_false": [
        "No, [A] is not to the right of [B].",
        "Incorrect — [A] is actually on the left side of [B].",
        "No, [A] appears left of [B].",
        "That's not the case; [A] is positioned further left than [B].",
        "Negative: [A] lies to the left of [B].",
        "No — relative to [B], [A] is on the left.",
        "No, in this view [A] is on the left-hand side of [B].",
        "It isn't — [A] is placed left of [B] in the scene.",
    ],
    "above_q": [
        "Is [A] above [B]?",
        "Does [A] sit higher than [B]?",
        "Is [A] positioned over [B]?",
        "Would you say [A] is located above [B]?",
        "In the scene, does [A] appear higher up than [B]?",
        "Is the vertical position of [A] above that of [B]?",
        "Does [A] rise above [B] in this image?",
        "Comparing heights of placement, is [A] the higher one relative to [B]?",
    ],
    "above_true": [
        "Yes, [A] is above [B].",
        "Correct — [A] sits higher than [B].",
        "Indeed, [A] is positioned over [B].",
        "That's right; [A] appears higher up than [B].",
        "Affirmative: [A] is located above [B].",
        "Yes — vertically, [A] is over [B].",
        "Yes, [A] rises above [B] here.",
        "It is — [A] occupies the higher position relative to [B].",
    ],
    "above_false": [
        "No, [A] is below [B].",
        "Incorrect — [A] actually sits lower than [B].",
        "No, [A] is positioned under [B].",
        "That's not the case; [A] appears lower than [B].",
        "Negative: [A] is located beneath [B].",
        "No — vertically, [A] is under [B].",
        "No, [A] sits below [B] here.",
        "It isn't — [A] occupies the lower position relative to [B].",
    ],
    "below_q": [
        "Is [A] below [B]?",
        "Is [A] positioned under [B]?",
        "Does [A] sit lower than [B]?",
        "Would you say [A] is located beneath [B]?",
        "In the scene, does [A] appear lower down than [B]?",
        "Is the vertical position of [A] under that of [B]?",
        "Does [A] lie underneath [B] in this image?",
        "Comparing heights of placement, is [A] the lower one relative to [B]?",
    ],
    "below_true": [
        "Yes, [A] is below [B].",
        "Correct — [A] sits lower than [B].",
        "Indeed, [A] is positioned under [B].",
        "That's right; [A] appears lower down than [B].",
        "Affirmative: [A] is located beneath [B].",
        "Yes — vertically, [A] is under [B].",
        "Yes, [A] lies underneath [B] here.",
        "It is — [A] occupies the lower position relative to [B].",
    ],
    "below_false": [
        "No, [A] is above [B].",
        "Incorrect — [A] actually sits higher than [B].",
        "No, [A] is positioned over [B].",
        "That's not the case; [A] appears higher than [B].",
        "Negative: [A] is located above [B].",
        "No — vertically, [A] is over [B].",
        "No, [A] rises above [B] here.",
        "It isn't — [A] occupies the higher position relative to [B].",
    ],
    "wide_q": [
        "Is [A] wider than [B]?",
        "Does [A] have a greater width than [B]?",
        "Would you say [A] spans more width than [B]?",
        "Comparing the two, is [A] the wider one versus [B]?",
        "Does [A] measure broader across than [B]?",
        "Is the width of [A] larger than the width of [B]?",
        "Side to side, does [A] extend further than [B]?",
        "Is [A] broader than [B]?",
    ],
    "wide_true": [
        "Yes, [A] is wider than [B].",
        "Correct — [A] has the greater width.",
        "Indeed, [A] spans more width than [B].",
        "That's right; [A] measures broader across than [B].",
        "Affirmative: the width of [A] exceeds that of [B].",
        "Yes — side to side, [A] extends further than [B].",
        "Yes, [A] is the broader of the two.",
        "It is — [A] comes out wider than [B].",
    ],
    "wide_false": [
        "No, [A] is narrower than [B].",
        "Incorrect — [B] has the greater width.",
        "No, [A] spans less width than [B].",
        "That's not the case; [A] measures slimmer across than [B].",
        "Negative: the width of [A] is smaller than that of [B].",
        "No — side to side, [B] extends further than [A].",
        "No, [A] is the narrower of the two.",
        "It isn't — [A] comes out thinner than [B].",
    ],
    "thin_q": [
        "Is [A] thinner than [B]?",
        "Does [A] have a smaller width than [B]?",
        "Would you say [A] is narrower than [B]?",
        "Comparing the two, is [A] the slimmer one versus [B]?",
        "Does [A] measure less across than [B]?",
        "Is the width of [A] smaller than the width of [B]?",
        "Side to side, does [A] extend less than [B]?",
        "Is [A] the narrower object compared with [B]?",
    ],
    "thin_true": [
        "Yes, [A] is thinner than [B].",
        "Correct — [A] has the smaller width.",
        "Indeed, [A] is narrower than [B].",
        "That's right; [A] measures less across than [B].",
        "Affirmative: the width of [A] is below that of [B].",
        "Yes — side to side, [A] extends less than [B].",
        "Yes, [A] is the slimmer of the two.",
        "It is — [A] comes out narrower than [B].",
    ],
    "thin_false": [
        "No, [A] is wider than [B].",
        "Incorrect — [A] has the greater width.",
        "No, [A] is broader than [B].",
        "That's not the case; [A] measures more across than [B].",
        "Negative: the width of [A] exceeds that of [B].",
        "No — side to side, [A] extends further than [B].",
        "No, [A] is the wider of the two.",
        "It isn't — [A] comes out broader than [B].",
    ],
    "big_q": [
        "Is [A] bigger than [B]?",
        "Does [A] take up more space than [B]?",
        "Would you say [A] is larger than [B]?",
        "Comparing overall size, does [A] exceed [B]?",
        "Is [A] the larger object versus [B]?",
        "Does [A] occupy a greater volume than [B]?",
        "Overall, does [A] outsize [B]?",
        "Is the size of [A] greater than the size of [B]?",
    ],
    "big_true": [
        "Yes, [A] is bigger than [B].",
        "Correct — [A] takes up more space than [B].",
        "Indeed, [A] is the larger of the two.",
        "That's right; [A] exceeds [B] in overall size.",
        "Affirmative: [A] occupies a greater volume than [B].",
        "Yes — overall, [A] outsizes [B].",
        "Yes, [A] comes out larger than [B].",
        "It is — the size of [A] is greater than [B]'s.",
    ],
    "big_false": [
        "No, [A] is smaller than [B].",
        "Incorrect — [B] takes up more space than [A].",
        "No, [A] is the smaller of the two.",
        "That's not the case; [B] exceeds [A] in overall size.",
        "Negative: [A] occupies less volume than [B].",
        "No — overall, [B] outsizes [A].",
        "No, [A] comes out smaller than [B].",
        "It isn't — the size of [A] is below [B]'s.",
    ],
    "small_q": [
        "Is [A] smaller than [B]?",
        "Does [A] take up less space than [B]?",
        "Would you say [A] is more compact than [B]?",
        "Comparing overall size, does [A] fall short of [B]?",
        "Is [A] the smaller object versus [B]?",
        "Does [A] occupy less volume than [B]?",
        "Overall, is [A] outsized by [B]?",
        "Is the size of [A] less than the size of [B]?",
    ],
    "small_true": [
        "Yes, [A] is smaller than [B].",
        "Correct — [A] takes up less space than [B].",
        "Indeed, [A] is the more compact of the two.",
        "That's right; [A] falls short of [B] in overall size.",
        "Affirmative: [A] occupies less volume than [B].",
        "Yes — overall, [B] outsizes [A].",
        "Yes, [A] comes out smaller than [B].",
        "It is — the size of [A] is below [B]'s.",
    ],
    "small_false": [
        "No, [A] is bigger than [B].",
        "Incorrect — [A] takes up more space than [B].",
        "No, [A] is the larger of the two.",
        "That's not the case; [A] exceeds [B] in overall size.",
        "Negative: [A] occupies a greater volume than [B].",
        "No — overall, [A] outsizes [B].",
        "No, [A] comes out larger than [B].",
        "It isn't — the size of [A] is greater than [B]'s.",
    ],
    "tall_q": [
        "Is [A] taller than [B]?",
        "Does [A] stand higher than [B]?",
        "Would you say [A] has more height than [B]?",
        "Comparing their heights, does [A] exceed [B]?",
        "Is [A] the taller object versus [B]?",
        "Does [A] reach higher than [B] does?",
        "Top to bottom, does [A] measure more than [B]?",
        "Is the height of [A] greater than the height of [B]?",
    ],
    "tall_true": [
        "Yes, [A] is taller than [B].",
        "Correct — [A] stands higher than [B].",
        "Indeed, [A] has more height than [B].",
        "That's right; [A] exceeds [B] in height.",
        "Affirmative: [A] is the taller of the two.",
        "Yes — [A] reaches higher than [B].",
        "Yes, top to bottom [A] measures more than [B].",
        "It is — the height of [A] tops [B]'s.",
    ],
    "tall_false": [
        "No, [A] is shorter than [B].",
        "Incorrect — [B] stands higher than [A].",
        "No, [A] has less height than [B].",
        "That's not the case; [B] exceeds [A] in height.",
        "Negative: [A] is the shorter of the two.",
        "No — [B] reaches higher than [A].",
        "No, top to bottom [A] measures less than [B].",
        "It isn't — the height of [A] falls below [B]'s.",
    ],
    "short_q": [
        "Is [A] shorter than [B]?",
        "Does [A] stand lower than [B]?",
        "Would you say [A] has less height than [B]?",
        "Comparing their heights, does [A] fall below [B]?",
        "Is [A] the shorter object versus [B]?",
        "Does [A] reach less high than [B] does?",
        "Top to bottom, does [A] measure less than [B]?",
        "Is the height of [A] smaller than the height of [B]?",
    ],
    "short_true": [
        "Yes, [A] is shorter than [B].",
        "Correct — [A] stands lower than [B].",
        "Indeed, [A] has less height than [B].",
        "That's right; [A] falls below [B] in height.",
        "Affirmative: [A] is the shorter of the two.",
        "Yes — [A] reaches less high than [B].",
        "Yes, top to bottom [A] measures less than [B].",
        "It is — the height of [A] falls below [B]'s.",
    ],
    "short_false": [
        "No, [A] is taller than [B].",
        "Incorrect — [A] stands higher than [B].",
        "No, [A] has more height than [B].",
        "That's not the case; [A] exceeds [B] in height.",
        "Negative: [A] is the taller of the two.",
        "No — [A] reaches higher than [B].",
        "No, top to bottom [A] measures more than [B].",
        "It isn't — the height of [A] tops [B]'s.",
    ],
    "behind_q": [
        "Is [A] behind [B]?",
        "Is [A] farther from the camera than [B]?",
        "Does [A] sit deeper in the scene than [B]?",
        "Would you say [A] is positioned in back of [B]?",
        "From this viewpoint, is [A] the more distant of the two?",
        "Is [A] located further away than [B]?",
        "Depth-wise, does [A] lie beyond [B]?",
        "Is [A] at a greater distance from the viewer than [B]?",
    ],
    "behind_true": [
        "Yes, [A] is behind [B].",
        "Correct — [A] is farther from the camera than [B].",
        "Indeed, [A] sits deeper in the scene than [B].",
        "That's right; [A] is positioned in back of [B].",
        "Affirmative: [A] is the more distant of the two.",
        "Yes — [A] is located further away than [B].",
        "Yes, depth-wise [A] lies beyond [B].",
        "It is — [A] sits at a greater distance from the viewer.",
    ],
    "behind_false": [
        "No, [A] is in front of [B].",
        "Incorrect — [A] is closer to the camera than [B].",
        "No, [A] sits nearer in the scene than [B].",
        "That's not the case; [A] is positioned ahead of [B].",
        "Negative: [A] is the closer of the two.",
        "No — [A] is located nearer than [B].",
        "No, depth-wise [A] lies before [B].",
        "It isn't — [A] sits closer to the viewer.",
    ],
    "front_q": [
        "Is [A] in front of [B]?",
        "Is [A] closer to the camera than [B]?",
        "Does [A] sit nearer in the scene than [B]?",
        "Would you say [A] is positioned ahead of [B]?",
        "From this viewpoint, is [A] the closer of the two?",
        "Is [A] located nearer than [B]?",
        "Depth-wise, does [A] lie before [B]?",
        "Is [A] at a smaller distance from the viewer than [B]?",
    ],
    "front_true": [
        "Yes, [A] is in front of [B].",
        "Correct — [A] is closer to the camera than [B].",
        "Indeed, [A] sits nearer in the scene than [B].",
        "That's right; [A] is positioned ahead of [B].",
        "Affirmative: [A] is the closer of the two.",
        "Yes — [A] is located nearer than [B].",
        "Yes, depth-wise [A] lies before [B].",
        "It is — [A] sits closer to the viewer.",
    ],
    "front_false": [
        "No, [A] is behind [B].",
        "Incorrect — [A] is farther from the camera than [B].",
        "No, [A] sits deeper in the scene than [B].",
        "That's not the case; [A] is positioned in back of [B].",
        "Negative: [A] is the more distant of the two.",
        "No — [A] is located further away than [B].",
        "No, depth-wise [A] lies beyond [B].",
        "It isn't — [A] sits farther from the viewer.",
    ],
}

CHOICE_TEMPLATES: T = {
    "left_q": [
        "Which is more to the left, [A] or [B]?",
        "Between [A] and [B], which one appears further left?",
        "Of the two, [A] and [B], which sits leftmost?",
        "Which object is on the left: [A] or [B]?",
        "Looking at the image, which lies further to the left — [A] or [B]?",
        "Pick the one positioned more to the left: [A] or [B].",
        "From this view, which of [A] and [B] is the left one?",
        "Which one would you find further left, [A] or [B]?",
    ],
    "right_q": [
        "Which is more to the right, [A] or [B]?",
        "Between [A] and [B], which one appears further right?",
        "Of the two, [A] and [B], which sits rightmost?",
        "Which object is on the right: [A] or [B]?",
        "Looking at the image, which lies further to the right — [A] or [B]?",
        "Pick the one positioned more to the right: [A] or [B].",
        "From this view, which of [A] and [B] is the right one?",
        "Which one would you find further right, [A] or [B]?",
    ],
    "above_q": [
        "Which is higher up, [A] or [B]?",
        "Between [A] and [B], which one sits higher?",
        "Of the two, [A] and [B], which is positioned above the other?",
        "Which object appears higher in the scene: [A] or [B]?",
        "Looking at the image, which lies further up — [A] or [B]?",
        "Pick the one placed higher: [A] or [B].",
        "From this view, which of [A] and [B] occupies the upper position?",
        "Which one would you find higher, [A] or [B]?",
    ],
    "below_q": [
        "Which is lower down, [A] or [B]?",
        "Between [A] and [B], which one sits lower?",
        "Of the two, [A] and [B], which is positioned beneath the other?",
        "Which object appears lower in the scene: [A] or [B]?",
        "Looking at the image, which lies further down — [A] or [B]?",
        "Pick the one placed lower: [A] or [B].",
        "From this view, which of [A] and [B] occupies the lower position?",
        "Which one would you find lower, [A] or [B]?",
    ],
    "tall_q": [
        "Which is taller, [A] or [B]?",
        "Between [A] and [B], which one has more height?",
        "Of the two, [A] and [B], which stands taller?",
        "Which object reaches higher: [A] or [B]?",
        "Comparing heights, which wins — [A] or [B]?",
        "Pick the taller one: [A] or [B].",
        "From this view, which of [A] and [B] measures more top to bottom?",
        "Which one would you call taller, [A] or [B]?",
    ],
    "short_q": [
        "Which is shorter, [A] or [B]?",
        "Between [A] and [B], which one has less height?",
        "Of the two, [A] and [B], which stands shorter?",
        "Which object reaches less high: [A] or [B]?",
        "Comparing heights, which comes up short — [A] or [B]?",
        "Pick the shorter one: [A] or [B].",
        "From this view, which of [A] and [B] measures less top to bottom?",
        "Which one would you call shorter, [A] or [B]?",
    ],
    "answer": [
        "[X] is the one.",
        "That would be [X].",
        "It's [X].",
        "The answer is [X].",
        "[X].",
        "That's [X] in this scene.",
        "Of the two, [X].",
        "[X] fits that description.",
    ],
}

QUANT_TEMPLATES: T = {
    "vertical_distance_q": [
        "How far apart are [A] and [B] vertically?",
        "What is the vertical gap between [A] and [B]?",
        "What vertical distance separates [A] and [B]?",
        "Measured straight up and down, how far is [A] from [B]?",
        "How much vertical separation lies between [A] and [B]?",
        "Estimate the vertical distance from [A] to [B].",
        "Vertically speaking, what is the gap between [A] and [B]?",
        "How large is the height difference in position between [A] and [B]?",
    ],
    "vertical_distance_a": [
        "[A] and [B] are [X] apart vertically.",
        "The vertical distance between [A] and [B] is [X].",
        "Vertically, [A] is [X] away from [B].",
        "A vertical gap of [X] separates [A] and [B].",
        "Straight up and down, the two are [X] apart.",
        "The vertical separation of [A] from [B] measures [X].",
        "[A] sits about [X] apart from [B] in the vertical direction.",
        "There is roughly [X] of vertical distance between [A] and [B].",
    ],
    "horizontal_distance_q": [
        "How far apart are [A] and [B] horizontally?",
        "What is the horizontal gap between [A] and [B]?",
        "What horizontal distance separates [A] and [B]?",
        "Measured side to side, how far is [A] from [B]?",
        "How much horizontal separation lies between [A] and [B]?",
        "Estimate the horizontal distance from [A] to [B].",
        "Horizontally speaking, what is the gap between [A] and [B]?",
        "How large is the sideways offset between [A] and [B]?",
    ],
    "horizontal_distance_a": [
        "[A] and [B] are [X] apart horizontally.",
        "The horizontal distance between [A] and [B] is [X].",
        "Horizontally, [A] is [X] away from [B].",
        "A horizontal gap of [X] separates [A] and [B].",
        "Side to side, the two are [X] apart.",
        "The horizontal separation of [A] from [B] measures [X].",
        "[A] sits about [X] apart from [B] in the horizontal direction.",
        "There is roughly [X] of horizontal distance between [A] and [B].",
    ],
    "distance_q": [
        "How far is [A] from [B]?",
        "What is the distance between [A] and [B]?",
        "How much distance separates [A] and [B]?",
        "Estimate the gap between [A] and [B].",
        "How far away is [A] from [B] in this scene?",
        "What distance would you measure from [A] to [B]?",
        "Roughly how far apart are [A] and [B]?",
        "Can you give the distance separating [A] from [B]?",
    ],
    "distance_a": [
        "[A] and [B] are [X] apart.",
        "The distance between [A] and [B] is [X].",
        "[A] sits [X] away from [B].",
        "A gap of [X] separates [A] and [B].",
        "They are roughly [X] apart.",
        "From [A] to [B] measures about [X].",
        "You would measure about [X] between [A] and [B].",
        "The separation between [A] and [B] comes to [X].",
    ],
    "width_q": [
        "How wide is [A]?",
        "Measure the width of [A].",
        "What is the width of [A]?",
        "How broad is [A]?",
        "How much does [A] span side to side?",
        "Estimate how wide [A] is.",
        "What would you say the width of [A] measures?",
        "Across its widest point, how wide is [A]?",
    ],
    "width_a": [
        "[A] is [X] wide.",
        "The width of [A] is [X].",
        "[A] measures [X] across.",
        "[A] spans about [X] side to side.",
        "Its width comes to [X].",
        "[A] is roughly [X] in width.",
        "Across, [A] measures [X].",
        "The width of [A] comes out to [X].",
    ],
    "height_q": [
        "How tall is [A]?",
        "What is the height of [A]?",
        "Measure the height of [A].",
        "How high does [A] stand?",
        "How much does [A] measure top to bottom?",
        "Estimate how tall [A] is.",
        "What would you say the height of [A] measures?",
        "From base to top, how tall is [A]?",
    ],
    "height_a": [
        "[A] is [X] tall.",
        "The height of [A] is [X].",
        "[A] stands [X] high.",
        "[A] measures [X] top to bottom.",
        "Its height comes to [X].",
        "[A] is roughly [X] in height.",
        "From base to top, [A] measures [X].",
        "The height of [A] comes out to [X].",
    ],
    "direction_q": [
        "If you are at [A], where will you find [B]?",
        "Standing at [A], in which clock direction is [B]?",
        "From [A]'s position, which o'clock direction points to [B]?",
        "If you stand where [A] is, which way is [B]?",
        "Treating [A] as the center of a clock face, where does [B] lie?",
        "From the viewpoint of [A], at what o'clock is [B]?",
        "Imagine yourself at [A]; in which direction would [B] be?",
        "Using clock directions from [A], where is [B]?",
    ],
    "direction_a": [
        "[B] is around the [X] o'clock direction from [A].",
        "From [A], [B] lies at roughly [X] o'clock.",
        "Standing at [A], you would find [B] toward [X] o'clock.",
        "[B] sits in the [X] o'clock direction relative to [A].",
        "At about [X] o'clock from [A] — that's where [B] is.",
        "Looking out from [A], [B] is near the [X] o'clock mark.",
        "Relative to [A], [B] falls around [X] o'clock.",
        "From [A]'s position, [B] is situated at [X] o'clock.",
    ],
}


# ---------------------------------------------------------------------------
# Predicates (decision rules mirrored from prompt.py)
# ---------------------------------------------------------------------------


def _fill(template: str, A: str, B: str = "", X: str = "") -> str:
    return template.replace("[A]", A).replace("[B]", B).replace("[X]", X)


def _qa(bank_q, true_bank, false_bank, truth, A_desc, B_desc, rng) -> Tuple[str, str]:
    q = _fill(rng.choice(bank_q), A_desc, B_desc)
    a = _fill(rng.choice(true_bank if truth else false_bank), A_desc, B_desc)
    return q, a


def _bool_predicate(key: str, truth_fn: Callable):
    def fn(A, B, rng=random):
        a_desc, b_desc = A["caption"].lower(), B["caption"].lower()
        truth = truth_fn(A["pcd"], B["pcd"])
        return _qa(
            PREDICATE_TEMPLATES[f"{key}_q"],
            PREDICATE_TEMPLATES[f"{key}_true"],
            PREDICATE_TEMPLATES[f"{key}_false"],
            truth,
            a_desc,
            b_desc,
            rng,
        )

    fn.__name__ = f"{key}_predicate"
    return fn


# frame: +x is LEFT (geometry.unproject flips), +y up, +z forward
left_predicate = _bool_predicate("left", lambda a, b: a.get_center()[0] > b.get_center()[0])
right_predicate = _bool_predicate("right", lambda a, b: a.get_center()[0] < b.get_center()[0])
above_predicate = _bool_predicate("above", lambda a, b: a.get_center()[1] > b.get_center()[1])
below_predicate = _bool_predicate("below", lambda a, b: a.get_center()[1] < b.get_center()[1])
wide_predicate = _bool_predicate("wide", lambda a, b: a.extent()[0] > b.extent()[0])
thin_predicate = _bool_predicate("thin", lambda a, b: a.extent()[0] < b.extent()[0])
big_predicate = _bool_predicate("big", lambda a, b: np.prod(a.extent()) > np.prod(b.extent()))
small_predicate = _bool_predicate("small", lambda a, b: np.prod(a.extent()) < np.prod(b.extent()))
tall_predicate = _bool_predicate("tall", lambda a, b: a.extent()[1] > b.extent()[1])
short_predicate = _bool_predicate("short", lambda a, b: a.extent()[1] < b.extent()[1])
behind_predicate = _bool_predicate("behind", lambda a, b: a.get_center()[2] > b.get_center()[2])
front_predicate = _bool_predicate("front", lambda a, b: a.get_center()[2] < b.get_center()[2])


def _choice(key: str, winner_fn: Callable):
    def fn(A, B, rng=random):
        a_desc, b_desc = A["caption"].lower(), B["caption"].lower()
        winner = a_desc if winner_fn(A["pcd"], B["pcd"]) else b_desc
        q = _fill(rng.choice(CHOICE_TEMPLATES[f"{key}_q"]), a_desc, b_desc)
        a = _fill(rng.choice(CHOICE_TEMPLATES["answer"]), a_desc, b_desc, winner)
        return q, a

    fn.__name__ = f"{key}_choice"
    return fn


left_choice = _choice("left", lambda a, b: a.get_center()[0] > b.get_center()[0])
right_choice = _choice("right", lambda a, b: a.get_center()[0] < b.get_center()[0])
above_choice = _choice("above", lambda a, b: a.get_center()[1] > b.get_center()[1])
below_choice = _choice("below", lambda a, b: a.get_center()[1] < b.get_center()[1])
tall_choice = _choice("tall", lambda a, b: a.extent()[1] > b.extent()[1])
short_choice = _choice("short", lambda a, b: a.extent()[1] < b.extent()[1])


# ---------------------------------------------------------------------------
# Quantitative generators
# ---------------------------------------------------------------------------


def vertical_distance_data(A, B, rng=random):
    a_desc, b_desc = A["caption"].lower(), B["caption"].lower()
    dist = abs(A["pcd"].get_center()[1] - B["pcd"].get_center()[1])
    x = human_like_distance(dist, rng)
    q = _fill(rng.choice(QUANT_TEMPLATES["vertical_distance_q"]), a_desc, b_desc)
    a = _fill(rng.choice(QUANT_TEMPLATES["vertical_distance_a"]), a_desc, b_desc, x)
    return q, a


def horizontal_distance_data(A, B, rng=random):
    a_desc, b_desc = A["caption"].lower(), B["caption"].lower()
    dist = abs(A["pcd"].get_center()[0] - B["pcd"].get_center()[0])
    x = human_like_distance(dist, rng)
    q = _fill(rng.choice(QUANT_TEMPLATES["horizontal_distance_q"]), a_desc, b_desc)
    a = _fill(rng.choice(QUANT_TEMPLATES["horizontal_distance_a"]), a_desc, b_desc, x)
    return q, a


def distance_data(A, B, rng=random):
    a_desc, b_desc = A["caption"].lower(), B["caption"].lower()
    x = human_like_distance(average_cloud_distance(A["pcd"], B["pcd"]), rng)
    q = _fill(rng.choice(QUANT_TEMPLATES["distance_q"]), a_desc, b_desc)
    a = _fill(rng.choice(QUANT_TEMPLATES["distance_a"]), a_desc, b_desc, x)
    return q, a


def width_data(A, B=None, rng=random):
    a_desc = A["caption"].lower()
    x = human_like_distance(float(A["pcd"].extent()[0]), rng)
    return (
        _fill(rng.choice(QUANT_TEMPLATES["width_q"]), a_desc),
        _fill(rng.choice(QUANT_TEMPLATES["width_a"]), a_desc, "", x),
    )


def height_data(A, B=None, rng=random):
    a_desc = A["caption"].lower()
    x = human_like_distance(float(A["pcd"].extent()[1]), rng)
    return (
        _fill(rng.choice(QUANT_TEMPLATES["height_q"]), a_desc),
        _fill(rng.choice(QUANT_TEMPLATES["height_a"]), a_desc, "", x),
    )


def direction(A, B, rng=random):
    a_desc, b_desc = A["caption"].lower(), B["caption"].lower()
    a_c, b_c = A["pcd"].get_center(), B["pcd"].get_center()
    clock = calculate_angle_clockwise((a_c[0], a_c[2]), (b_c[0], b_c[2]))
    q = _fill(rng.choice(QUANT_TEMPLATES["direction_q"]), a_desc, b_desc)
    a = _fill(rng.choice(QUANT_TEMPLATES["direction_a"]), a_desc, b_desc, str(int(clock)))
    return q, a


QUALITATIVE_PROMPTS = [
    left_predicate,
    left_choice,
    right_predicate,
    right_choice,
    wide_predicate,
    thin_predicate,
    big_predicate,
    small_predicate,
    behind_predicate,
    front_predicate,
    tall_predicate,
    tall_choice,
    short_predicate,
    short_choice,
    above_predicate,
    above_choice,
    below_predicate,
    below_choice,
]

QUANTITATIVE_PROMPTS = [
    direction,
    vertical_distance_data,
    horizontal_distance_data,
    width_data,
    height_data,
    distance_data,
]


class PromptGenerator:
    """Pair selection + predicate sampling (prompt.py:597-652)."""

    def __init__(self, n_pairs: int = 3, n_conv: int = 3, seed: Optional[int] = None):
        self.n_pairs = n_pairs
        self.n_conv = n_conv
        self.rng = random.Random(seed)

    def evaluate_predicates_on_pairs(self, detections: List[Dict]) -> List[Tuple]:
        combos = list(combinations(range(len(detections)), 2))
        self.rng.shuffle(combos)
        selected = combos[: self.n_pairs]
        prompts = QUALITATIVE_PROMPTS + QUANTITATIVE_PROMPTS
        results = []
        for i, j in selected:
            A, B = detections[i], detections[j]
            for fn in self.rng.sample(prompts, self.n_conv):
                results.append((fn(A, B, rng=self.rng), A, B, fn.__name__))
        return results


# ---------------------------------------------------------------------------
# Facts & instruction-style variants (run_template_facts.py / instruction.py)
# ---------------------------------------------------------------------------

FACT_TEMPLATES: T = {
    "left": ["[A] is to the left of [B]."],
    "right": ["[A] is to the right of [B]."],
    "above": ["[A] is above [B]."],
    "below": ["[A] is below [B]."],
    "wide": ["[A] is wider than [B]."],
    "thin": ["[A] is thinner than [B]."],
    "big": ["[A] is bigger than [B]."],
    "small": ["[A] is smaller than [B]."],
    "tall": ["[A] is taller than [B]."],
    "short": ["[A] is shorter than [B]."],
    "behind": ["[A] is behind [B]."],
    "front": ["[A] is in front of [B]."],
    "distance": ["[A] and [B] are [X] apart."],
    "width": ["[A] is [X] wide."],
    "height": ["[A] is [X] tall."],
}


def facts_for_pair(A: Dict, B: Dict, rng=random) -> List[str]:
    """Declarative spatial facts for one object pair (the facts-generation
    path, run_template_facts.py): only TRUE statements are emitted."""
    a, b = A["caption"].lower(), B["caption"].lower()
    pa, pb = A["pcd"], B["pcd"]
    facts = []

    def emit(key, A_desc=a, B_desc=b, X=""):
        facts.append(_fill(rng.choice(FACT_TEMPLATES[key]), A_desc, B_desc, X))

    emit("left" if pa.get_center()[0] > pb.get_center()[0] else "right")
    emit("above" if pa.get_center()[1] > pb.get_center()[1] else "below")
    emit("behind" if pa.get_center()[2] > pb.get_center()[2] else "front")
    emit("wide" if pa.extent()[0] > pb.extent()[0] else "thin")
    emit("tall" if pa.extent()[1] > pb.extent()[1] else "short")
    emit("big" if np.prod(pa.extent()) > np.prod(pb.extent()) else "small")
    emit("distance", X=human_like_distance(average_cloud_distance(pa, pb), rng))
    emit("width", X=human_like_distance(float(pa.extent()[0]), rng))
    emit("height", X=human_like_distance(float(pa.extent()[1]), rng))
    return facts


def tag_regions(text: str, detections: List[Dict]) -> str:
    """Replace object captions with 'Region [i] <mask>' tags so facts/QA
    become region-grounded instruction data (instruction.py's tagged
    variant; the <mask> token count must match the region count)."""
    out = text
    for i, det in enumerate(detections):
        cap = det["caption"].lower()
        out = out.replace(cap, f"Region [{i}] <mask>")
    return out


class InstructionGenerator(PromptGenerator):
    """PromptGenerator emitting region-tagged instruction conversations
    (instruction.py + instruction_template.py behavior)."""

    def conversations(self, detections: List[Dict]) -> List[Dict]:
        results = self.evaluate_predicates_on_pairs(detections)
        convs = []
        for (q, a), A, B, name in results:
            convs.append(
                {
                    "from_pair": (A["caption"], B["caption"]),
                    "type": name,
                    "conversations": [
                        {"from": "human", "value": tag_regions(q, detections)},
                        {"from": "gpt", "value": tag_regions(a, detections)},
                    ],
                }
            )
        return convs


# ---------------------------------------------------------------------------
# Paraphrase-bank extension to reference density (VERDICT r3 next-#7)
# ---------------------------------------------------------------------------
# The reference's prompt_template.py carries 14-16+ wordings per family
# (16 distance questions alone); language diversity of the synthesized
# data tracks bank size.  These additions (own wording) bring every
# question/answer bank to >= 16 entries; merged below at import.

_PREDICATE_EXTRA: T = {
    "left_q": [
        "Judging by this image, would [A] be to the left of [B]?",
        "Is it correct that [A] lies left of [B]?",
        "If you look at [B], is [A] off to its left?",
        "Is [A] located on the left when compared with [B]?",
        "True or false: [A] is to the left of [B].",
        "Could you confirm whether [A] is left of [B]?",
        "With [B] as the reference, does [A] fall on the left?",
        "Between the two, does [A] occupy the position left of [B]?",
    ],
    "left_true": [
        "True — [A] falls on the left side of [B].",
        "Confirmed: [A] is left of [B].",
        "Right you are, [A] keeps to the left of [B].",
        "Exactly — with [B] as the reference, [A] is on the left.",
        "Quite so; [A] takes the left position relative to [B].",
        "Certainly — [A] shows up left of [B] here.",
        "Looking at [B], [A] is indeed off to its left.",
        "Correct, the left position belongs to [A], not [B].",
    ],
    "left_false": [
        "False — [A] falls on the right side of [B].",
        "Not so: [A] is right of [B].",
        "Actually, [A] keeps to the right of [B].",
        "Quite the opposite — with [B] as the reference, [A] is on the right.",
        "Not quite; [A] takes the right position relative to [B].",
        "Hardly — [A] shows up right of [B] here.",
        "Looking at [B], [A] is actually off to its right.",
        "Wrong way around — the left position belongs to [B], not [A].",
    ],
    "right_q": [
        "Judging by this image, would [A] be to the right of [B]?",
        "Is it correct that [A] lies right of [B]?",
        "If you look at [B], is [A] off to its right?",
        "Is [A] located on the right when compared with [B]?",
        "True or false: [A] is to the right of [B].",
        "Could you confirm whether [A] is right of [B]?",
        "With [B] as the reference, does [A] fall on the right?",
        "Between the two, does [A] occupy the position right of [B]?",
    ],
    "right_true": [
        "True — [A] falls on the right side of [B].",
        "Confirmed: [A] is right of [B].",
        "Right you are, [A] keeps to the right of [B].",
        "Exactly — with [B] as the reference, [A] is on the right.",
        "Quite so; [A] takes the right position relative to [B].",
        "Certainly — [A] shows up right of [B] here.",
        "Looking at [B], [A] is indeed off to its right.",
        "Correct, the right position belongs to [A], not [B].",
    ],
    "right_false": [
        "False — [A] falls on the left side of [B].",
        "Not so: [A] is left of [B].",
        "Actually, [A] keeps to the left of [B].",
        "Quite the opposite — with [B] as the reference, [A] is on the left.",
        "Not quite; [A] takes the left position relative to [B].",
        "Hardly — [A] shows up left of [B] here.",
        "Looking at [B], [A] is actually off to its left.",
        "Wrong way around — the right position belongs to [B], not [A].",
    ],
    "above_q": [
        "Judging by this image, would [A] be above [B]?",
        "Is it correct that [A] lies above [B]?",
        "True or false: [A] is positioned above [B].",
        "Could you confirm whether [A] is higher than [B]?",
        "With [B] as the reference, does [A] sit above it?",
        "Between the two, does [A] occupy the upper spot over [B]?",
        "Is [A] located higher up when compared with [B]?",
        "Would [A] count as the one above [B] here?",
    ],
    "above_true": [
        "True — [A] sits above [B].",
        "Confirmed: [A] is higher than [B].",
        "Exactly — [A] holds the upper spot over [B].",
        "Quite so; [A] stays above [B] in this scene.",
        "Certainly — [A] shows up higher than [B] here.",
        "Right — compared with [B], [A] is the higher one.",
        "Correct, the upper position belongs to [A].",
        "Indeed it is — [A] hangs above [B].",
    ],
    "above_false": [
        "False — [A] sits below [B].",
        "Not so: [A] is lower than [B].",
        "Quite the opposite — [A] holds the lower spot under [B].",
        "Not quite; [A] stays beneath [B] in this scene.",
        "Hardly — [A] shows up lower than [B] here.",
        "Wrong — compared with [B], [A] is the lower one.",
        "Actually, the upper position belongs to [B].",
        "It's the reverse — [A] hangs below [B].",
    ],
    "below_q": [
        "Judging by this image, would [A] be below [B]?",
        "Is it correct that [A] lies beneath [B]?",
        "True or false: [A] is positioned below [B].",
        "Could you confirm whether [A] is lower than [B]?",
        "With [B] as the reference, does [A] sit beneath it?",
        "Between the two, does [A] occupy the lower spot under [B]?",
        "Is [A] located lower down when compared with [B]?",
        "Would [A] count as the one underneath [B] here?",
    ],
    "below_true": [
        "True — [A] sits below [B].",
        "Confirmed: [A] is lower than [B].",
        "Exactly — [A] holds the lower spot under [B].",
        "Quite so; [A] stays beneath [B] in this scene.",
        "Certainly — [A] shows up lower than [B] here.",
        "Right — compared with [B], [A] is the lower one.",
        "Correct, the lower position belongs to [A].",
        "Indeed it is — [A] rests underneath [B].",
    ],
    "below_false": [
        "False — [A] sits above [B].",
        "Not so: [A] is higher than [B].",
        "Quite the opposite — [A] holds the upper spot over [B].",
        "Not quite; [A] stays above [B] in this scene.",
        "Hardly — [A] shows up higher than [B] here.",
        "Wrong — compared with [B], [A] is the higher one.",
        "Actually, the lower position belongs to [B].",
        "It's the reverse — [A] hangs above [B].",
    ],
    "wide_q": [
        "Judging by this image, would [A] be wider than [B]?",
        "Is it correct that [A] has the greater width of the two?",
        "True or false: [A] is wider than [B].",
        "Could you confirm whether [A] out-spans [B] in width?",
        "Put side by side, would [A] cover more width than [B]?",
        "Does [A] beat [B] on width?",
        "Width-wise, does [A] come out ahead of [B]?",
        "Would [A] count as the broader one next to [B]?",
    ],
    "wide_true": [
        "True — [A] is the wider of the pair.",
        "Confirmed: [A] out-spans [B] in width.",
        "Exactly — [A] covers more width than [B].",
        "Quite so; width-wise [A] comes out ahead.",
        "Certainly — [A] beats [B] on width.",
        "Right — put side by side, [A] is broader.",
        "Correct, the greater width belongs to [A].",
        "Indeed it is — [A] stretches wider than [B].",
    ],
    "wide_false": [
        "False — [A] is the narrower of the pair.",
        "Not so: [B] out-spans [A] in width.",
        "Quite the opposite — [B] covers more width than [A].",
        "Not quite; width-wise [B] comes out ahead.",
        "Hardly — [B] beats [A] on width.",
        "Wrong — put side by side, [A] is slimmer.",
        "Actually, the greater width belongs to [B].",
        "It's the reverse — [A] stretches less wide than [B].",
    ],
    "thin_q": [
        "Judging by this image, would [A] be thinner than [B]?",
        "Is it correct that [A] has the smaller width of the two?",
        "True or false: [A] is narrower than [B].",
        "Could you confirm whether [B] out-spans [A] in width?",
        "Put side by side, would [A] cover less width than [B]?",
        "Does [A] lose to [B] on width?",
        "Width-wise, does [A] come out behind [B]?",
        "Would [A] count as the slimmer one next to [B]?",
    ],
    "thin_true": [
        "True — [A] is the slimmer of the pair.",
        "Confirmed: [B] out-spans [A] in width.",
        "Exactly — [A] covers less width than [B].",
        "Quite so; width-wise [A] comes out behind.",
        "Certainly — [A] loses to [B] on width.",
        "Right — put side by side, [A] is narrower.",
        "Correct, the smaller width belongs to [A].",
        "Indeed it is — [A] stretches less wide than [B].",
    ],
    "thin_false": [
        "False — [A] is the broader of the pair.",
        "Not so: [A] out-spans [B] in width.",
        "Quite the opposite — [A] covers more width than [B].",
        "Not quite; width-wise [A] comes out ahead.",
        "Hardly — [A] beats [B] on width.",
        "Wrong — put side by side, [A] is wider.",
        "Actually, the smaller width belongs to [B].",
        "It's the reverse — [A] stretches wider than [B].",
    ],
    "big_q": [
        "Judging by this image, would [A] be bigger than [B]?",
        "Is it correct that [A] is the larger of the two?",
        "True or false: [A] is bigger than [B].",
        "Could you confirm whether [A] outranks [B] in size?",
        "All dimensions considered, is [A] larger than [B]?",
        "Does [A] beat [B] on overall size?",
        "Size-wise, does [A] come out ahead of [B]?",
        "Would [A] count as the bulkier one next to [B]?",
    ],
    "big_true": [
        "True — [A] is the larger of the pair.",
        "Confirmed: [A] outranks [B] in size.",
        "Exactly — all dimensions considered, [A] is larger.",
        "Quite so; size-wise [A] comes out ahead.",
        "Certainly — [A] beats [B] on overall size.",
        "Right — [A] is the bulkier one here.",
        "Correct, the greater bulk belongs to [A].",
        "Indeed it is — [A] dwarfs [B] overall.",
    ],
    "big_false": [
        "False — [A] is the smaller of the pair.",
        "Not so: [B] outranks [A] in size.",
        "Quite the opposite — all dimensions considered, [B] is larger.",
        "Not quite; size-wise [B] comes out ahead.",
        "Hardly — [B] beats [A] on overall size.",
        "Wrong — [B] is the bulkier one here.",
        "Actually, the greater bulk belongs to [B].",
        "It's the reverse — [B] dwarfs [A] overall.",
    ],
    "small_q": [
        "Judging by this image, would [A] be smaller than [B]?",
        "Is it correct that [A] is the lesser of the two in size?",
        "True or false: [A] is smaller than [B].",
        "Could you confirm whether [B] outranks [A] in size?",
        "All dimensions considered, is [A] smaller than [B]?",
        "Does [A] lose to [B] on overall size?",
        "Size-wise, does [A] come out behind [B]?",
        "Would [A] count as the more modest one next to [B]?",
    ],
    "small_true": [
        "True — [A] is the smaller of the pair.",
        "Confirmed: [B] outranks [A] in size.",
        "Exactly — all dimensions considered, [A] is smaller.",
        "Quite so; size-wise [A] comes out behind.",
        "Certainly — [A] loses to [B] on overall size.",
        "Right — [A] is the more modest one here.",
        "Correct, the lesser bulk belongs to [A].",
        "Indeed it is — [B] dwarfs [A] overall.",
    ],
    "small_false": [
        "False — [A] is the larger of the pair.",
        "Not so: [A] outranks [B] in size.",
        "Quite the opposite — all dimensions considered, [A] is larger.",
        "Not quite; size-wise [A] comes out ahead.",
        "Hardly — [A] beats [B] on overall size.",
        "Wrong — [A] is the bulkier one here.",
        "Actually, the lesser bulk belongs to [B].",
        "It's the reverse — [A] dwarfs [B] overall.",
    ],
    "tall_q": [
        "Judging by this image, would [A] be taller than [B]?",
        "Is it correct that [A] has the greater height of the two?",
        "True or false: [A] is taller than [B].",
        "Could you confirm whether [A] rises above [B] in height?",
        "Measured upward, does [A] go further than [B]?",
        "Does [A] beat [B] on height?",
        "Height-wise, does [A] come out ahead of [B]?",
        "Would [A] count as the taller one next to [B]?",
    ],
    "tall_true": [
        "True — [A] is the taller of the pair.",
        "Confirmed: [A] rises above [B] in height.",
        "Exactly — measured upward, [A] goes further.",
        "Quite so; height-wise [A] comes out ahead.",
        "Certainly — [A] beats [B] on height.",
        "Right — [A] towers over [B] here.",
        "Correct, the greater height belongs to [A].",
        "Indeed it is — [A] overtops [B].",
    ],
    "tall_false": [
        "False — [A] is the shorter of the pair.",
        "Not so: [B] rises above [A] in height.",
        "Quite the opposite — measured upward, [B] goes further.",
        "Not quite; height-wise [B] comes out ahead.",
        "Hardly — [B] beats [A] on height.",
        "Wrong — [B] towers over [A] here.",
        "Actually, the greater height belongs to [B].",
        "It's the reverse — [B] overtops [A].",
    ],
    "short_q": [
        "Judging by this image, would [A] be shorter than [B]?",
        "Is it correct that [A] has the smaller height of the two?",
        "True or false: [A] is shorter than [B].",
        "Could you confirm whether [B] rises above [A] in height?",
        "Measured upward, does [A] stop sooner than [B]?",
        "Does [A] lose to [B] on height?",
        "Height-wise, does [A] come out behind [B]?",
        "Would [A] count as the shorter one next to [B]?",
    ],
    "short_true": [
        "True — [A] is the shorter of the pair.",
        "Confirmed: [B] rises above [A] in height.",
        "Exactly — measured upward, [A] stops sooner.",
        "Quite so; height-wise [A] comes out behind.",
        "Certainly — [A] loses to [B] on height.",
        "Right — [B] towers over [A] here.",
        "Correct, the smaller height belongs to [A].",
        "Indeed it is — [B] overtops [A].",
    ],
    "short_false": [
        "False — [A] is the taller of the pair.",
        "Not so: [A] rises above [B] in height.",
        "Quite the opposite — measured upward, [A] goes further.",
        "Not quite; height-wise [A] comes out ahead.",
        "Hardly — [A] beats [B] on height.",
        "Wrong — [A] towers over [B] here.",
        "Actually, the smaller height belongs to [B].",
        "It's the reverse — [A] overtops [B].",
    ],
    "behind_q": [
        "Judging by this image, would [A] be behind [B]?",
        "Is it correct that [A] sits further back than [B]?",
        "True or false: [A] is behind [B].",
        "Could you confirm whether [A] lies deeper into the scene than [B]?",
        "Relative to the camera, is [A] the farther one of the two?",
        "Does [A] recede further into the background than [B]?",
        "In terms of depth, does [A] fall past [B]?",
        "Would [A] count as the one tucked behind [B] here?",
    ],
    "behind_true": [
        "True — [A] sits further back than [B].",
        "Confirmed: [A] lies deeper into the scene.",
        "Exactly — relative to the camera, [A] is the farther one.",
        "Quite so; [A] recedes further into the background.",
        "Certainly — in depth terms, [A] falls past [B].",
        "Right — [A] is tucked behind [B] here.",
        "Correct, the deeper position belongs to [A].",
        "Indeed it is — [A] stands in back of [B].",
    ],
    "behind_false": [
        "False — [A] sits nearer than [B].",
        "Not so: [A] lies closer to the front of the scene.",
        "Quite the opposite — relative to the camera, [A] is the nearer one.",
        "Not quite; [A] comes forward of [B] here.",
        "Hardly — in depth terms, [A] stops short of [B].",
        "Wrong — [B] is the one tucked behind.",
        "Actually, the deeper position belongs to [B].",
        "It's the reverse — [A] stands in front of [B].",
    ],
    "front_q": [
        "Judging by this image, would [A] be in front of [B]?",
        "Is it correct that [A] sits nearer than [B]?",
        "True or false: [A] is in front of [B].",
        "Could you confirm whether [A] lies closer to the viewer than [B]?",
        "Relative to the camera, is [A] the nearer one of the two?",
        "Does [A] come forward of [B] in the scene?",
        "In terms of depth, does [A] stop short of [B]?",
        "Would [A] count as the one out in front of [B] here?",
    ],
    "front_true": [
        "True — [A] sits nearer than [B].",
        "Confirmed: [A] lies closer to the viewer.",
        "Exactly — relative to the camera, [A] is the nearer one.",
        "Quite so; [A] comes forward of [B] in the scene.",
        "Certainly — in depth terms, [A] stops short of [B].",
        "Right — [A] is out in front of [B] here.",
        "Correct, the nearer position belongs to [A].",
        "Indeed it is — [A] stands before [B].",
    ],
    "front_false": [
        "False — [A] sits further back than [B].",
        "Not so: [A] lies deeper into the scene.",
        "Quite the opposite — relative to the camera, [A] is the farther one.",
        "Not quite; [A] recedes behind [B] here.",
        "Hardly — in depth terms, [A] falls past [B].",
        "Wrong — [A] is the one tucked behind.",
        "Actually, the nearer position belongs to [B].",
        "It's the reverse — [A] stands in back of [B].",
    ],
}

_CHOICE_EXTRA: T = {
    "left_q": [
        "Name the one that sits further left: [A] or [B].",
        "If you had to choose, which is leftmost — [A] or [B]?",
        "Out of [A] and [B], which claims the left position?",
        "Toward the left edge of the view, do you find [A] or [B]?",
        "Which of the pair leans left: [A] or [B]?",
        "Say which one is closer to the left side — [A] or [B].",
        "Identify the left-hand object among [A] and [B].",
        "[A] or [B] — which shows up on the left?",
    ],
    "right_q": [
        "Name the one that sits further right: [A] or [B].",
        "If you had to choose, which is rightmost — [A] or [B]?",
        "Out of [A] and [B], which claims the right position?",
        "Toward the right edge of the view, do you find [A] or [B]?",
        "Which of the pair leans right: [A] or [B]?",
        "Say which one is closer to the right side — [A] or [B].",
        "Identify the right-hand object among [A] and [B].",
        "[A] or [B] — which shows up on the right?",
    ],
    "above_q": [
        "Name the one that sits higher: [A] or [B].",
        "If you had to choose, which is the upper one — [A] or [B]?",
        "Out of [A] and [B], which claims the higher spot?",
        "Toward the top of the view, do you find [A] or [B]?",
        "Which of the pair rides higher: [A] or [B]?",
        "Say which one is nearer the top — [A] or [B].",
        "Identify the upper object among [A] and [B].",
        "[A] or [B] — which shows up higher?",
    ],
    "below_q": [
        "Name the one that sits lower: [A] or [B].",
        "If you had to choose, which is the lower one — [A] or [B]?",
        "Out of [A] and [B], which claims the lower spot?",
        "Toward the bottom of the view, do you find [A] or [B]?",
        "Which of the pair rides lower: [A] or [B]?",
        "Say which one is nearer the bottom — [A] or [B].",
        "Identify the lower object among [A] and [B].",
        "[A] or [B] — which shows up lower?",
    ],
    "tall_q": [
        "Name the taller of the two: [A] or [B].",
        "If you had to choose, which stands taller — [A] or [B]?",
        "Out of [A] and [B], which claims the greater height?",
        "On height alone, do you pick [A] or [B]?",
        "Which of the pair rises higher: [A] or [B]?",
        "Say which one has more height — [A] or [B].",
        "Identify the taller object among [A] and [B].",
        "[A] or [B] — which stands the taller?",
    ],
    "short_q": [
        "Name the shorter of the two: [A] or [B].",
        "If you had to choose, which stands shorter — [A] or [B]?",
        "Out of [A] and [B], which claims the lesser height?",
        "On height alone, which falls short — [A] or [B]?",
        "Which of the pair rises less: [A] or [B]?",
        "Say which one has less height — [A] or [B].",
        "Identify the shorter object among [A] and [B].",
        "[A] or [B] — which stands the shorter?",
    ],
    "answer": [
        "[X] is the correct pick.",
        "Go with [X].",
        "[X] takes it.",
        "That title goes to [X].",
        "Here it's [X].",
        "[X] — that one.",
        "The one you want is [X].",
        "[X] matches what you asked.",
    ],
}

_QUANT_EXTRA: T = {
    "vertical_distance_q": [
        "Give me the vertical gap from [A] to [B].",
        "Measured along the vertical, what separates [A] and [B]?",
        "Could you put a number on the vertical distance between [A] and [B]?",
        "Tell me how far [A] sits from [B] in the up-down direction.",
        "What's the up-down separation between [A] and [B]?",
        "In the vertical direction, how much space lies between [A] and [B]?",
        "Work out the vertical distance separating [A] from [B].",
        "How big is the vertical offset from [A] to [B]?",
    ],
    "vertical_distance_a": [
        "Call it [X] in the vertical direction.",
        "About [X] of up-down separation lies between them.",
        "The up-down gap from [A] to [B] comes to [X].",
        "Vertically the pair are separated by [X].",
        "[X] — that's the vertical offset between [A] and [B].",
        "In the vertical direction, the answer is [X].",
        "The measurement comes out near [X] vertically.",
        "Expect roughly [X] between [A] and [B], measured up and down.",
    ],
    "horizontal_distance_q": [
        "Give me the horizontal gap from [A] to [B].",
        "Measured along the horizontal, what separates [A] and [B]?",
        "Could you put a number on the horizontal distance between [A] and [B]?",
        "Tell me how far [A] sits from [B] in the side-to-side direction.",
        "What's the side-to-side separation between [A] and [B]?",
        "In the horizontal direction, how much space lies between [A] and [B]?",
        "Work out the horizontal distance separating [A] from [B].",
        "How big is the lateral offset from [A] to [B]?",
    ],
    "horizontal_distance_a": [
        "Call it [X] in the horizontal direction.",
        "About [X] of side-to-side separation lies between them.",
        "The lateral gap from [A] to [B] comes to [X].",
        "Horizontally the pair are separated by [X].",
        "[X] — that's the lateral offset between [A] and [B].",
        "In the horizontal direction, the answer is [X].",
        "The measurement comes out near [X] horizontally.",
        "Expect roughly [X] between [A] and [B], measured side to side.",
    ],
    "distance_q": [
        "Give me the distance from [A] to [B].",
        "Could you put a number on the gap between [A] and [B]?",
        "Tell me how far [A] sits from [B].",
        "What's the separation between [A] and [B]?",
        "How much space lies between [A] and [B]?",
        "Work out the distance separating [A] from [B].",
        "About how much distance stands between [A] and [B]?",
        "What gap would you estimate between [A] and [B]?",
    ],
    "distance_a": [
        "Call it [X].",
        "About [X] separates them.",
        "The gap from [A] to [B] comes to [X].",
        "The pair are separated by [X].",
        "[X] — that's the distance between [A] and [B].",
        "The answer is [X].",
        "The measurement comes out near [X].",
        "Expect roughly [X] between [A] and [B].",
    ],
    "width_q": [
        "Give me the width of [A].",
        "Could you put a number on how wide [A] is?",
        "Tell me the side-to-side measurement of [A].",
        "What does [A] measure across?",
        "How much width does [A] have?",
        "Work out how broad [A] is.",
        "About how wide would you call [A]?",
        "What width would you estimate for [A]?",
    ],
    "width_a": [
        "Call it [X] wide.",
        "About [X] across.",
        "The side-to-side measurement of [A] comes to [X].",
        "[A] carries a width of [X].",
        "[X] — that's how wide [A] is.",
        "Its breadth works out to [X].",
        "The width measures near [X].",
        "Expect roughly [X] of width for [A].",
    ],
    "height_q": [
        "Give me the height of [A].",
        "Could you put a number on how tall [A] is?",
        "Tell me the top-to-bottom measurement of [A].",
        "What does [A] measure from bottom to top?",
        "How much height does [A] have?",
        "Work out how high [A] stands.",
        "About how tall would you call [A]?",
        "What height would you estimate for [A]?",
    ],
    "height_a": [
        "Call it [X] tall.",
        "About [X] from bottom to top.",
        "The top-to-bottom measurement of [A] comes to [X].",
        "[A] carries a height of [X].",
        "[X] — that's how tall [A] is.",
        "Its stature works out to [X].",
        "The height measures near [X].",
        "Expect roughly [X] of height for [A].",
    ],
    "direction_q": [
        "Picture a clock centered on [A]: at which hour does [B] sit?",
        "From where [A] stands, what clock hour points at [B]?",
        "Give [B]'s bearing from [A] in clock terms.",
        "If [A] faced 12 o'clock, at which hour would [B] appear?",
        "Locate [B] on a clock dial drawn around [A].",
        "What o'clock reading takes you from [A] to [B]?",
        "Describe where [B] lies using the clock around [A].",
        "Starting at [A], which hour hand would point to [B]?",
    ],
    "direction_a": [
        "Call it [X] o'clock from [A] to [B].",
        "On a dial centered at [A], [B] reads about [X] o'clock.",
        "The bearing from [A] to [B] is near [X] o'clock.",
        "[B] shows up around the [X] o'clock mark as seen from [A].",
        "Check the [X] o'clock direction from [A] — [B] is there.",
        "An hour hand at [X] would point from [A] toward [B].",
        "From [A], the clock reading for [B] comes to [X].",
        "[X] o'clock — that's where [B] sits relative to [A].",
    ],
}

for _bank, _extra in (
    (PREDICATE_TEMPLATES, _PREDICATE_EXTRA),
    (CHOICE_TEMPLATES, _CHOICE_EXTRA),
    (QUANT_TEMPLATES, _QUANT_EXTRA),
):
    for _k, _v in _extra.items():
        _bank[_k].extend(_v)
