"""First-name pool for home naming.

The reference names homes ``names.get_first_name() + '-' + 5charsuffix``
(dragg/aggregator.py:396-397) via the third-party ``names`` package.  We
embed a small name pool instead; names are decorative identifiers, and the
seeded *parameter* streams (numpy) are what determine behavioral parity.
"""

FIRST_NAMES = [
    "Alice", "Alvin", "Amara", "Andre", "Anita", "Anthony", "April", "Arjun",
    "Astrid", "Avery", "Bianca", "Boris", "Brandon", "Bridget", "Bruno",
    "Camille", "Carlos", "Carmen", "Cedric", "Celia", "Chidi", "Clara",
    "Cormac", "Crystal", "Dahlia", "Damon", "Daniela", "Darius", "Dawn",
    "Declan", "Delia", "Dennis", "Dorothy", "Edgar", "Elena", "Elias",
    "Elsa", "Emeka", "Emil", "Erin", "Esme", "Ethan", "Farah", "Felix",
    "Fiona", "Floyd", "Freya", "Gary", "Gemma", "Gideon", "Gloria", "Grant",
    "Greta", "Hana", "Harvey", "Hazel", "Hector", "Helga", "Hugo", "Ian",
    "Ida", "Igor", "Imani", "Ingrid", "Irene", "Isaac", "Ivan", "Jada",
    "Jason", "Javier", "Jerome", "Joan", "Jonah", "Joyce", "Juan", "Judith",
    "Kai", "Kara", "Keiko", "Kelvin", "Kendra", "Kofi", "Kurt", "Laila",
    "Lars", "Laura", "Leif", "Lena", "Leo", "Lillie", "Linus", "Lorenzo",
    "Lucia", "Luther", "Mabel", "Magnus", "Maeve", "Marcus", "Margot",
    "Mariana", "Marvin", "Matilda", "Maya", "Mehmet", "Mei", "Milan",
    "Milo", "Mina", "Miriam", "Mohammed", "Myles", "Nadia", "Naomi",
    "Nathan", "Nelly", "Nestor", "Nia", "Nikolai", "Nina", "Noel", "Nora",
    "Odessa", "Olaf", "Olive", "Omar", "Oscar", "Otis", "Paige", "Pablo",
    "Pearl", "Pedro", "Petra", "Philip", "Priya", "Quentin", "Quinn",
    "Rafael", "Ramona", "Randall", "Raquel", "Ravi", "Regina", "Rhea",
    "Robert", "Rocco", "Rosa", "Rowan", "Ruby", "Rufus", "Sadie", "Salma",
    "Samuel", "Sanjay", "Saoirse", "Sasha", "Selene", "Serena", "Seth",
    "Shirley", "Silas", "Simone", "Sofia", "Soren", "Stella", "Sven",
    "Tamar", "Tariq", "Tessa", "Theo", "Thora", "Tobias", "Trudy", "Uma",
    "Ursula", "Valerie", "Vera", "Victor", "Vikram", "Viola", "Wade",
    "Walter", "Wanda", "Wendell", "Willa", "Xander", "Ximena", "Yara",
    "Yusuf", "Yvette", "Zainab", "Zelda", "Zora",
]
